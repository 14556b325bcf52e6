"""Scene layer: flat SoA scene tensors, procedural scenes, camera."""
