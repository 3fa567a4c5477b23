// The FFT stage launches of one tile width, LMVN_TILE (16, 8, 4 or 2): this
// file is compiled once per width, each in an nvcc process of its own, and
// the passes in fused.cu call them through the dispatch of fft_stage.cuh.

#include "fft_stage.cuh"

#ifndef LMVN_TILE
#error "compile with -DLMVN_TILE=<tile width>"
#endif

namespace lmvn_fft {

LMVN_FFT_TILE(, LMVN_TILE)

}  // namespace lmvn_fft
