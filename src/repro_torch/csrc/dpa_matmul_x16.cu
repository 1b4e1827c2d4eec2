// dpa_matmul_fused's split-K instances of fp16 x codes (fp16 activations;
// dpa_matmul.cuh), a source of their own so that the build compiles them
// in parallel with the others.
#include "dpa_matmul.cuh"

namespace dpa_splitk {

int run_x16(int x_bf16, int x_fmt, int w_fmt, const void* x, const void* wq,
            const float* sw, float* out, int E, int M, int K, int N, int bm,
            int bn, int split, cudaStream_t s) {
  return run<2>(x_bf16, x_fmt, w_fmt, x, wq, sw, out, E, M, K, N, bm, bn,
                split, s);
}

}  // namespace dpa_splitk
