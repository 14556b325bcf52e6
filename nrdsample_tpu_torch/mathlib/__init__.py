"""mathlib — MathLib (ml.hlsli) equivalents as plain torch functions,
vectorized over leading batch dims with length-3 trailing vector axes."""
