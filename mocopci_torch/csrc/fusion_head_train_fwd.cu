// Train fusion head, forward sweeps 0-3 (the kernel and its design are in
// fusion_head_train.cuh; the backward sweeps are in fusion_head_train_bwd.cu,
// which builds in parallel).
#include "fusion_head_train.cuh"

// One forward sweep.  x (G, 4, P) planes, G = F groups x Bg frame-major;
// params: the 13312 packed floats of fusion_head_train.cuh; stats (F, 2, 256)
// [mean | rstd] of the layers normalised so far.  Sweeps 0-2 write the
// group sums (sum z, sum z^2) of layer 1-3 to red; sweep 3 writes o (G, P) to
// out.  partial: nblk * red_size floats of scratch.
MOCOPCI_API int mocopci_fusion_head_train_fwd(const float* x, const float* params,
                                              const float* stats, float* out, float* partial,
                                              float* red, int mode, int G, int F, int P,
                                              int nblk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_sweep<0>(x, params, stats, out, partial, red, G, F, P, nblk, st);
    case 1: return launch_sweep<1>(x, params, stats, out, partial, red, G, F, P, nblk, st);
    case 2: return launch_sweep<2>(x, params, stats, out, partial, red, G, F, P, nblk, st);
    case 3: return launch_sweep<3>(x, params, stats, out, partial, red, G, F, P, nblk, st);
    default: return cudaErrorInvalidValue;
  }
}
