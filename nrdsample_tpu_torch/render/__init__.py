"""Render passes: hit decode, lighting, emissive IS, the opaque path tracer."""
