"""Single-device math: shapes, wrap, FFT, elementwise update, convolution."""
