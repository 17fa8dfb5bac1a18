// Phase 1 of the minimizer scan on Hopper (sm_90a): per-position window
// argmin z over a flat augmented base stream, in three modes, one launch
// entry each.
//
// Replaces the TPU kernel seqwin_tpu/engine/pallas_scan.py::_make_kernel:
//   phase1_z   (kernel B1) its z mode (out_mode='z', with_hashes=False);
//   phase1_zc  (kernel B2) its hash mode (with_hashes=True): z plus the
//              canonical hash of every position (one int64 where the TPU
//              writes lo/hi uint32 halves);
//   phase1_pfx (kernel B3) its pfx mode (out_mode='pfx'): the tile-local
//              inclusive prefix-max of z and the tile-local running count of
//              its increases.
//
// For every position p of the uint8 stream (bits 0..5 = base code, 0..3
// valid; bit 6 = record start; bytes outside the stream read as 255):
//   valid(q)   = no code > 3 in [q, q+k-1], no record start in [q+1, q+k-1],
//                q <= n - k
//   blocker(q) = !valid(q) or record start at q
//   clean(p)   = p >= w-1 and no blocker in [p-w+1, p]
//   z[p]       = rightmost position of the minimal canonical ntHash over
//                [p-w+1, p] (unsigned 64-bit compare, ties to the larger
//                position) when clean(p) and that minimum is not the
//                all-ones sentinel; else -1.
//   canon[p]   = the canonical ntHash of the k-mer at p where valid(p), else
//                0 (only valid positions are part of the contract).
//   zpfx[t][i] = max(z[tT .. tT+i]), positions past n counting as -1: the
//                prefix-max restarts at every tile's first output and never
//                carries the previous tile's maximum in.
//   lrank[t][i]= #{j <= i : zpfx[t][j] > zpfx[t][j-1]}, with -1 before j=0.
//
// Design: one CTA per tile of T output positions. The CTA stages the bytes
// [t0-(w-1), t0+T+k-1) in shared memory, hashes the T+w-1 positions its
// windows need with the per-offset rotated seed tables
// fwd[j][c] = srol^(k-1-j)(SEED[c]), rev[j][c] = srol^j(SEED_COMP[c])
// (native 64-bit arithmetic; the TPU kernel's u32-pair rotations, 128-lane
// rows and modular ladders exist only for Mosaic), then each thread scans
// the w hashes of its windows in shared memory with a plain loop. The pfx
// mode keeps the tile's z in shared memory and runs two block-wide scans
// over it (a max-scan, then a sum-scan of the increases): each thread folds
// T/256 consecutive entries, warps combine with __shfl_up_sync, and one
// shared-memory pass combines the eight warp totals. The TPU kernel's
// Hillis-Steele ladders over (rows, 128) exist only for the vector unit.
//
// Bounds on the H100, per position at 3.35 TB/s (the least bytes each
// function must move; their least arithmetic, a rolling hash and an
// amortised O(1) sliding minimum, is tens of integer operations per
// position, under 20 us per 2^25 positions at the card's rates, so bytes
// bound all three):
//   z:   1 B read + 4 B written  -> 2^25 positions: 168 MB, ~0.050 ms;
//   zc:  1 B read + 12 B written -> 2^25 positions: 436 MB, ~0.130 ms;
//   pfx: 1 B read + 8 B written  -> 2^25 positions: 302 MB, ~0.090 ms.
// This simple kernel spends ~2k table XORs per hashed position and w 64-bit
// compares per output, so it runs compute-bound far above those bounds; the
// prefix/suffix two-block scan is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kModeZ = 0;
constexpr int kModeZc = 1;
constexpr int kModePfx = 2;

// Block-wide exclusive scan of one value per thread (max when !kAdd, sum
// when kAdd); `identity` for thread 0. `sh` holds >= kThreads / 32 ints.
template <bool kAdd>
__device__ int block_exclusive(int x, int identity, int* sh) {
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    int v = x;
    for (int o = 1; o < 32; o <<= 1) {
        int t = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v = kAdd ? v + t : max(v, t);
    }
    int excl = __shfl_up_sync(0xffffffffu, v, 1);
    if (lane == 0) excl = identity;
    if (lane == 31) sh[wid] = v;
    __syncthreads();
    if (wid == 0) {
        int s = lane < kThreads / 32 ? sh[lane] : identity;
        for (int o = 1; o < 32; o <<= 1) {
            int t = __shfl_up_sync(0xffffffffu, s, o);
            if (lane >= o) s = kAdd ? s + t : max(s, t);
        }
        if (lane < kThreads / 32) sh[lane] = s;
    }
    __syncthreads();
    int before = wid > 0 ? sh[wid - 1] : identity;
    __syncthreads();  // sh is reused by the next scan
    return kAdd ? before + excl : max(before, excl);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
phase1_kernel(const uint8_t* __restrict__ codes, long long n, int k, int w,
              int tile, const unsigned long long* __restrict__ tabs,
              int32_t* __restrict__ z, long long* __restrict__ canon,
              int32_t* __restrict__ lrank) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int nh = tile + w - 1;           // hashed positions of this tile
    const int nc = nh + k - 1;             // staged bytes
    unsigned long long* h = reinterpret_cast<unsigned long long*>(smem);
    unsigned long long* ftab = h + nh;     // [k][4]
    unsigned long long* rtab = ftab + 4 * k;
    int32_t* zs = reinterpret_cast<int32_t*>(rtab + 4 * k);  // pfx mode only
    int32_t* ls = zs + (kMode == kModePfx ? tile : 0);
    int32_t* sh = ls + (kMode == kModePfx ? tile : 0);
    uint8_t* blk = reinterpret_cast<uint8_t*>(sh + (kMode == kModePfx ? 32 : 0));
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
        // invalid positions are blockers, so the argmin never reads them
        h[i] = valid ? f + r : 0ull;
        blk[i] = (!valid || (cs[i] & 64u)) ? 1 : 0;
    }
    __syncthreads();

    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
        long long p = t0 + i;
        int32_t zi = -1;
        if (p < n) {
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
            zi = (clean && best != ~0ull) ? (int32_t)(base + bi) : -1;
        }
        if (kMode == kModePfx) {
            zs[i] = zi;
        } else if (p < n) {
            z[p] = zi;
            if (kMode == kModeZc) canon[p] = (long long)h[i + w - 1];
        }
    }
    if (kMode != kModePfx) return;
    __syncthreads();

    // tile-local prefix-max and increase count; thread t owns the entries
    // [t * per, (t + 1) * per)
    const int per = tile / kThreads;
    const int i0 = threadIdx.x * per;
    int agg = -1;
    for (int i = i0; i < i0 + per; ++i) agg = max(agg, zs[i]);
    const int before = block_exclusive<false>(agg, -1, sh);  // = zpfx[i0-1], -1 at 0
    int m = before, cnt = 0;
    for (int i = i0; i < i0 + per; ++i) {
        int v = max(m, zs[i]);
        cnt += v > m;
        m = v;
        zs[i] = v;
    }
    int acc = block_exclusive<true>(cnt, 0, sh);
    m = before;
    for (int i = i0; i < i0 + per; ++i) {
        acc += zs[i] > m;
        m = zs[i];
        ls[i] = acc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
        z[t0 + i] = zs[i];
        lrank[t0 + i] = ls[i];
    }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA in `mode` (0 z, 1 zc, 2 pfx); the Python
// wrapper checks it against the card's per-block limit before launching.
long long phase1_smem_bytes(int k, int w, int tile, int mode) {
    long long nh = (long long)tile + w - 1;
    long long pfx = mode == kModePfx ? 8LL * tile + 4 * 32 : 0;
    return nh * 8 + 64LL * k + pfx + nh + nh + k - 1;
}

}  // extern "C"

namespace {

template <int kMode>
int launch(const void* codes, long long n, int k, int w, int tile,
           const void* tabs, void* z, void* canon, void* lrank, void* stream) {
    if (n <= 0) return 0;
    if (kMode == kModePfx && tile % kThreads != 0) return (int)cudaErrorInvalidValue;
    long long smem = phase1_smem_bytes(k, w, tile, kMode);
    cudaError_t err = cudaFuncSetAttribute(
        phase1_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    long long blocks = (n + tile - 1) / tile;
    phase1_kernel<kMode><<<(unsigned)blocks, kThreads, (size_t)smem,
                           (cudaStream_t)stream>>>(
        (const uint8_t*)codes, n, k, w, tile,
        (const unsigned long long*)tabs, (int32_t*)z, (long long*)canon,
        (int32_t*)lrank);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() of the
// launch (0 = ok). `tabs` is the int64[2, k, 4] rotated seed table.

// B1: z int32[n].
int phase1_z_launch(const void* codes, long long n, int k, int w, int tile,
                    const void* tabs, void* z, void* stream) {
    return launch<kModeZ>(codes, n, k, w, tile, tabs, z, nullptr, nullptr, stream);
}

// B2: z int32[n], canon int64[n].
int phase1_zc_launch(const void* codes, long long n, int k, int w, int tile,
                     const void* tabs, void* z, void* canon, void* stream) {
    return launch<kModeZc>(codes, n, k, w, tile, tabs, z, canon, nullptr, stream);
}

// B3: zpfx, lrank int32[ceil(n / tile) * tile]; tile a multiple of 256.
int phase1_pfx_launch(const void* codes, long long n, int k, int w, int tile,
                      const void* tabs, void* zpfx, void* lrank, void* stream) {
    return launch<kModePfx>(codes, n, k, w, tile, tabs, zpfx, nullptr, lrank, stream);
}

}  // extern "C"
