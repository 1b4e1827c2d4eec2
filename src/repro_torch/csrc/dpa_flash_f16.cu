// dpa_flash_attention's fp16-attention kernels at hd 64 and 128
// (dpa_flash.cuh), a source of their own so that the build compiles them
// in parallel with the others.
#include "dpa_flash.cuh"

namespace dpa_flash {

cudaError_t run_f16(int q_bf16, int hd, int kv_fmt, const Params& p,
                    int B, cudaStream_t s) {
  return run<dpa::kGridF16, false>(q_bf16, hd, kv_fmt, p, B, s);
}

}  // namespace dpa_flash
