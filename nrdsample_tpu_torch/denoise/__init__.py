"""Denoiser stack. Ported so far: REFERENCE accumulation and composition."""
