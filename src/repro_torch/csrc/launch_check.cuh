// The grid check of every serve-path launcher (K1, K2, K3's two passes, K4,
// K5) and of K5's and K4's backward. A wrapper computes the grids of its
// launches from the shapes alone
// (repro_torch/kernels/introspect.py: the LaunchGrid that STEP007 of
// `python -m repro_torch.stepcheck` proves in bounds on the CPU) and passes
// them as n_grids x 3 ints (x, y, z per launch, in launch order). The
// launcher holds them against the grids it would launch, before it launches
// anything, and refuses a mismatch with cudaErrorInvalidValue: the grid the
// checker proved and the grid the card runs cannot drift apart unnoticed.
// A few integer compares on the host per call.
#pragma once

#include <cuda_runtime.h>

// True where `want` (n_want x 3 ints) lists exactly the n_have grids `have`.
inline bool grids_match(const int* want, int n_want, const dim3* have,
                        int n_have) {
  if (want == nullptr || n_want != n_have) return false;
  for (int i = 0; i < n_have; ++i)
    if (want[3 * i] != (int)have[i].x || want[3 * i + 1] != (int)have[i].y ||
        want[3 * i + 2] != (int)have[i].z)
      return false;
  return true;
}
