// Train fusion head, backward sweeps 4-7 (the kernel and its design are in
// fusion_head_train.cuh).
#include "fusion_head_train.cuh"

// One backward sweep, with the forward's inputs and stats, bsum (F, 2, 256)
// [Sa | Sb] of the layers whose backward sums are known, and dout (G, P).
// Sweep 4 writes the layer-3 group sums to red; sweeps 5, 6 the layer-2 / 1
// group sums then dW, db of the layer above; sweep 7 writes dx (G, 4, P) to
// out and dW1, db1 to red.
MOCOPCI_API int mocopci_fusion_head_train_bwd(const float* x, const float* params,
                                              const float* stats, const float* bsum,
                                              const float* dout, float* out, float* partial,
                                              float* red, int mode, int G, int F, int P,
                                              int nblk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 4: return launch_sweep<4>(x, params, stats, bsum, dout, out, partial, red, G, F, P, nblk, st);
    case 5: return launch_sweep<5>(x, params, stats, bsum, dout, out, partial, red, G, F, P, nblk, st);
    case 6: return launch_sweep<6>(x, params, stats, bsum, dout, out, partial, red, G, F, P, nblk, st);
    case 7: return launch_sweep<7>(x, params, stats, bsum, dout, out, partial, red, G, F, P, nblk, st);
    default: return cudaErrorInvalidValue;
  }
}
