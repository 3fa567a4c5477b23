"""Device ms per stack of the kernels the fused engine launches
(``ops/fused.py`` through ``fft_stage.cuh`` and ``fft_long.cu``), matched by
the names below."""

NAMES = ("lmvn_fft::", "fft_long", "col_fft_kernel", "chirp_kernel", "bhat_kernel",
         "x_gather_", "x_scatter_", "x_op_kernel", "y_gather", "y_scatter", "z_gather",
         "z_kmul", "z_scatter")


def read(w):
    s = w.kernel_s(lambda n: any(k in n for k in NAMES))
    if s <= 0.0:
        w.notes.append("fused_ms_per_stack: no fused-engine kernel in the window")
        return None
    return 1e3 * s / w.stacks
