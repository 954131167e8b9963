// The (q/k head dim, v head dim) pairs that K1's split, wgmma and tf32x3
// kernels and K2/K3's wgmma and tf32x3 kernels instantiate: pairs, not a
// cross product, since the build time grows with each one. (d, d) for the
// Perceiver AR families; d = 32 with v's own width for the Perceiver IO
// masked LM at language-perceiver width (8 heads over qk 256, v 1280 in the
// encoder and 768 in the decoder); (160, 160) for the Perceiver IO text
// families at the JAX CLI's defaults (8 heads over 1280 latent channels,
// q/k and v channels unset) and the text classifier's decoder. Every other
// pair takes the `wide` kernels (csrc/flash_attention_{fwd,bwd}_wide.cu),
// d and dv at run time. `ops/flash_attention.py` HEAD_DIMS is this list;
// tests/test_torch_port_ops.py holds the two equal.
//
// X(D, DV) is applied to every pair: each source expands it into its
// dispatch.
#pragma once

#define FLASH_HEAD_DIM_PAIRS(X) \
  X(32, 32)                     \
  X(32, 96)                     \
  X(32, 160)                    \
  X(64, 64)                     \
  X(96, 96)                     \
  X(112, 112)                   \
  X(128, 128)                   \
  X(160, 160)
