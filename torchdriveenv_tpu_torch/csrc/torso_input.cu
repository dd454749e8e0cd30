// The NatureCNN torso's input on the card, for NVIDIA Hopper (sm_90a): a
// uint8 frame stack (B, C, H, W), contiguous, to obs / 255 in bfloat16 as a
// channels-last tensor (memory order B, H, W, C), the layout cuDNN's bf16
// tensor-op convolutions run in.
//
// Replaces no TPU kernel: the JAX package divides in plain jnp
// (torchdriveenv_tpu/models/cnn.py:30, NatureCNN.__call__), and the port's
// plain twin is models/cnn.py:nhwc_input. It takes the place of that twin
// for every bf16 torso input on the card.
//
// What bounds it on the card: bytes. Each byte of the stack is read once and
// each bf16 value written once, 3 bytes an element (56.6 MB for a batch of
// 512 stacks of 9 x 64 x 64, 16.9 us at 3.35 TB/s); the arithmetic is one
// table lookup an element. The twin, a TensorIterator over a channels-last
// output, gathers its bytes from C planes apart and ran at ~0.6 TB/s.
//
// Design (one block per sample and band of `rows` image rows, grid =
// (B, ceil(H / rows)): grid.x is the batch):
//   - The block's 256 threads first fill a 256-entry table of the bf16
//     value of u / 255 for every byte u in shared memory.
//   - Load: the band's C planes (rows x W bytes each, contiguous in the
//     stack) are copied into shared memory, 16 bytes a thread a step where W
//     is a multiple of 16, a byte a step otherwise; each plane's row in
//     shared memory is padded by 16 bytes so that the gathers below fall in
//     other banks.
//   - Store: the band's output is rows x W x C contiguous bf16 values in
//     (h, w, c) order. Each thread takes 8 consecutive values, gathers their
//     bytes from the C planes, looks them up and writes them with one
//     16-byte store where W x C is a multiple of 8, one at a time otherwise.
//
// Bit-equality with the twin: the twin divides in f32 by a device tensor
// (one IEEE division, u / 255.0f, exact operands since 0..255 and 255 are
// bf16 values) and rounds once to bf16, to nearest even. The table holds
// __float2bfloat16_rn(__fdiv_rn(u, 255.0f)): the same division and the same
// rounding, whatever the division flags.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTable = 256;           // one entry a byte value
constexpr int kPad = 16;              // bytes after each plane's band

__global__ void __launch_bounds__(kThreads)
torso_input_kernel(const uint8_t* __restrict__ obs,
                   uint16_t* __restrict__ out, int c, int h, int w, int rows,
                   int vec_in, int vec_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* table = reinterpret_cast<uint16_t*>(smem);
  uint8_t* band = smem + kTable * sizeof(uint16_t);

  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const int h0 = blockIdx.y * rows;
  const int nr = min(rows, h - h0);
  const int plane = nr * w;             // bytes of one channel in the band
  const int pitch = rows * w + kPad;    // their stride in shared memory
  const size_t hw = (size_t)h * w;

  for (int u = tid; u < kTable; u += blockDim.x)
    table[u] = __bfloat16_as_ushort(
        __float2bfloat16_rn(__fdiv_rn((float)u, 255.0f)));

  const uint8_t* src = obs + b * c * hw + (size_t)h0 * w;
  if (vec_in) {
    const int per = plane / 16;
    for (int i = tid; i < c * per; i += blockDim.x) {
      const int ch = i / per, k = i - ch * per;
      const uint4 v = reinterpret_cast<const uint4*>(src + ch * hw)[k];
      reinterpret_cast<uint4*>(band + ch * pitch)[k] = v;
    }
  } else {
    for (int i = tid; i < c * plane; i += blockDim.x) {
      const int ch = i / plane, k = i - ch * plane;
      band[ch * pitch + k] = src[ch * hw + k];
    }
  }
  __syncthreads();

  uint16_t* dst = out + (b * h + h0) * (size_t)w * c;
  const int n = plane * c;              // values of the band, (h, w, c) order
  if (vec_out) {
    for (int i = tid; i < n / 8; i += blockDim.x) {
      int p = (i * 8) / c, ch = i * 8 - p * c;
      uint32_t packed[4];
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const uint32_t lo = table[band[ch * pitch + p]];
        if (++ch == c) { ch = 0; ++p; }
        const uint32_t hi = table[band[ch * pitch + p]];
        if (++ch == c) { ch = 0; ++p; }
        packed[j / 2] = lo | (hi << 16);
      }
      reinterpret_cast<uint4*>(dst)[i] =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  } else {
    for (int i = tid; i < n; i += blockDim.x) {
      const int p = i / c, ch = i - p * c;
      dst[i] = table[band[ch * pitch + p]];
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError() after
// the launch: 0 when it was accepted. `obs` is uint8 (b, c, h, w),
// contiguous; `out` bf16 (b, h, w, c), contiguous. `rows` image rows a
// block; `vec_in`: w is a multiple of 16 and obs is 16-byte aligned;
// `vec_out`: w * c is a multiple of 8 and out is 16-byte aligned. Nothing is
// launched for b == 0.
int tde_torso_input(const void* obs, void* out, int b, int c, int h, int w,
                    int rows, int vec_in, int vec_out, void* stream) {
  if (b == 0) return 0;
  const dim3 grid(b, (h + rows - 1) / rows);
  const size_t smem = kTable * sizeof(uint16_t) + (size_t)c * (rows * w + kPad);
  torso_input_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(obs), static_cast<uint16_t*>(out), c, h, w,
      rows, vec_in, vec_out);
  return (int)cudaGetLastError();
}

const char* tde_torso_input_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
