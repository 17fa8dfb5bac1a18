// Phase 1 of the minimizer scan on Hopper (sm_90a): per-position window
// argmin z over a flat augmented base stream.
//
// Replaces the TPU kernel seqwin_tpu/engine/pallas_scan.py::_make_kernel in
// its z mode (out_mode='z', with_hashes=False). For every position p of the
// uint8 stream (bits 0..5 = base code, 0..3 valid; bit 6 = record start;
// bytes outside the stream read as 255):
//   valid(q)   = no code > 3 in [q, q+k-1], no record start in [q+1, q+k-1],
//                q <= n - k
//   blocker(q) = !valid(q) or record start at q
//   clean(p)   = p >= w-1 and no blocker in [p-w+1, p]
//   z[p]       = rightmost position of the minimal canonical ntHash over
//                [p-w+1, p] (unsigned 64-bit compare, ties to the larger
//                position) when clean(p) and that minimum is not the
//                all-ones sentinel; else -1.
//
// Design: one CTA per tile of T output positions. The CTA stages the bytes
// [t0-(w-1), t0+T+k-1) in shared memory, hashes the T+w-1 positions its
// windows need with the per-offset rotated seed tables
// fwd[j][c] = srol^(k-1-j)(SEED[c]), rev[j][c] = srol^j(SEED_COMP[c])
// (native 64-bit arithmetic; the TPU kernel's u32-pair rotations, 128-lane
// rows and modular ladders exist only for Mosaic), then each thread scans
// the w hashes of its windows in shared memory with a plain loop.
//
// Bound on the H100: the function reads 1 B and writes 4 B per position, so
// a 2^25-position chunk moves 168 MB: ~50 us at 3.35 TB/s. Its least
// arithmetic (a rolling hash and an amortised O(1) sliding minimum) is tens
// of integer operations per position, under 20 us at the card's rates, so
// bytes bound it. This simple kernel spends ~2k table XORs per hashed
// position and w 64-bit compares per output, so it runs compute-bound far
// above that bound; the prefix/suffix two-block scan is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
phase1_z_kernel(const uint8_t* __restrict__ codes, long long n, int k, int w,
                int tile, const unsigned long long* __restrict__ tabs,
                int32_t* __restrict__ z) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int nh = tile + w - 1;           // hashed positions of this tile
    const int nc = nh + k - 1;             // staged bytes
    unsigned long long* h = reinterpret_cast<unsigned long long*>(smem);
    unsigned long long* ftab = h + nh;     // [k][4]
    unsigned long long* rtab = ftab + 4 * k;
    uint8_t* blk = reinterpret_cast<uint8_t*>(rtab + 4 * k);
    uint8_t* cs = blk + nh;

    const long long t0 = (long long)blockIdx.x * tile;
    const long long base = t0 - (w - 1);   // stream position of h[0] / cs[0]

    for (int i = threadIdx.x; i < nc; i += blockDim.x) {
        long long q = base + i;
        cs[i] = (q >= 0 && q < n) ? codes[q] : (uint8_t)255;
    }
    for (int i = threadIdx.x; i < 8 * k; i += blockDim.x) ftab[i] = tabs[i];
    __syncthreads();

    for (int i = threadIdx.x; i < nh; i += blockDim.x) {
        unsigned long long f = 0, r = 0;
        bool bad = false;
        for (int j = 0; j < k; ++j) {
            unsigned c = cs[i + j];
            unsigned code = c & 63u;
            if (code > 3u || (j > 0 && (c & 64u))) {
                bad = true;
                break;
            }
            f ^= ftab[4 * j + code];
            r ^= rtab[4 * j + code];
        }
        long long q = base + i;
        bool valid = !bad && q >= 0 && q <= n - k;
        h[i] = f + r;
        blk[i] = (!valid || (cs[i] & 64u)) ? 1 : 0;
    }
    __syncthreads();

    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
        long long p = t0 + i;
        if (p >= n) break;
        bool clean = p >= w - 1;
        unsigned long long best = ~0ull;
        int bi = -1;
        for (int j = i; clean && j < i + w; ++j) {  // h[i .. i+w-1] = [p-w+1, p]
            if (blk[j]) {
                clean = false;
            } else if (h[j] <= best) {
                best = h[j];
                bi = j;
            }
        }
        z[p] = (clean && best != ~0ull) ? (int32_t)(base + bi) : -1;
    }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA; the Python wrapper checks it against
// the card's per-block limit before launching.
long long phase1_z_smem_bytes(int k, int w, int tile) {
    long long nh = (long long)tile + w - 1;
    return nh * 8 + 64LL * k + nh + nh + k - 1;
}

// Launch on `stream`; returns cudaGetLastError() of the launch (0 = ok).
int phase1_z_launch(const void* codes, long long n, int k, int w, int tile,
                    const void* tabs, void* z, void* stream) {
    if (n <= 0) return 0;
    long long smem = phase1_z_smem_bytes(k, w, tile);
    cudaError_t err = cudaFuncSetAttribute(
        phase1_z_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    long long blocks = (n + tile - 1) / tile;
    phase1_z_kernel<<<(unsigned)blocks, kThreads, (size_t)smem,
                      (cudaStream_t)stream>>>(
        (const uint8_t*)codes, n, k, w, tile,
        (const unsigned long long*)tabs, (int32_t*)z);
    return (int)cudaGetLastError();
}

}  // extern "C"
