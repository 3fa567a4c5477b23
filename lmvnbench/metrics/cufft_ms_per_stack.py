"""Device ms per stack of cuFFT's kernels (the fft engine's transforms,
``core/convolve.py``), matched by the names below."""

NAMES = ("regular_fft", "vector_fft", "fft_", "cufft", "Radix", "radix")
OURS = ("lmvn_fft::", "fft_long", "col_fft_kernel")


def read(w):
    s = w.kernel_s(lambda n: any(k in n for k in NAMES) and not any(k in n for k in OURS))
    if s <= 0.0:
        w.notes.append("cufft_ms_per_stack: no cuFFT kernel in the window")
        return None
    return 1e3 * s / w.stacks
