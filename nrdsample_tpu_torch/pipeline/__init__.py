"""Frame orchestration: trace_frame -> image_frame over an explicit history."""
