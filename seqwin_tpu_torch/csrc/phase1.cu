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
// Design: one CTA of 256 threads per tile of T output positions (T is the
// wrapper's _TILE, 4096: the fastest of 2048, 4096 and 8192 in
// torch_phase1_tiles.py). It stages the bytes [t0-(w-1), t0+T+k-1) in
// shared memory, as 4-byte words, and hashes the nh = T+w-1 positions its
// windows need; local index i is stream position t0-(w-1)+i. Thread t owns
// the run [t*R, t*R+R) of local positions, R = ceil(nh/256) made odd (so
// that the threads' strided 8-byte shared accesses fall in distinct
// banks). Every stage is O(1) per position, whatever k and w are:
//  1. Rolling ntHash. The first k-mer of a run is hashed from the
//     per-offset tables fwd[j][c] = srol^(k-1-j)(SEED[c]),
//     rev[j][c] = srol^j(SEED_COMP[c]); the rest roll in native 64-bit
//     arithmetic (srol/sror are the 33/31-bit split rotations by one):
//       fwd(q+1) = srol(fwd(q)) ^ srol^k(SEED[c_q]) ^ SEED[c_{q+k}]
//       rev(q+1) = sror(rev(q) ^ SEED_COMP[c_q] ^ srol^k(SEED_COMP[c_{q+k}]))
//     where a code > 3 takes the seeds of its low two bits. Any seed does,
//     as long as a byte gives the same one entering and leaving: the XOR
//     recurrence then stays exact once the bad base has left the k-mer, and
//     positions whose k-mer holds it are invalid, their hash unused (zero
//     seeds would be as exact and cost a select more per pick). The eight
//     rolling seeds, SEED[c] = fwd[k-1][c] and srol^k(SEED[c]) =
//     srol(fwd[0][c]) (SEED_COMP[c] = SEED[3-c]), sit in registers and are
//     picked by code with selects. Validity follows a running "last
//     blocking byte": a code > 3 at b blocks k-mers up to b,
//     a record start at b those up to b-1, and the k-mer at q is valid iff
//     that last key is < q (padding bytes make q < 0 and q > n-k invalid).
//  2. Window argmin, the TPU kernel's segmented rightmost argmin: the
//     hashed span is cut into segments of exactly w positions from local
//     index 0. P[i] = argmin over [segment start, i], S[i] = argmin over
//     [i, segment end], z at i = rmin(S[i-w+1], P[i]) (the two cover the
//     window [i-w+1, i] exactly). Ties go right everywhere: rmin(l, r)
//     takes r on <=. The two scans are segmented block-wide scans: each
//     thread folds its run, warps combine with __shfl_up_sync (prefix) or
//     __shfl_down_sync (suffix) under a segment-head flag, and each thread
//     folds the eight warp totals from shared memory. S is kept as a
//     16-bit index per position (its hash is read back from the hashes);
//     P is carried in registers by the walk that writes z.
//  3. clean(p) is "last blocker at or before p < p-w+1": a block-wide
//     exclusive max-scan of each run's last blocker, then a running value.
//  4. Outputs: z goes through shared memory and out as 16-byte stores;
//     canon is stored coalesced from the hashes. The pfx mode scans the
//     tile's z with each thread on its own outputs (local [s-(w-1), e-(w-1))
//     of its run [s, e)): a max-scan, then a sum-scan of the increases.
//
// Bounds on the H100 (the least time for the same work; chip_smoke.py
// computes them for each input):
//   bytes at 3.35 TB/s, each input byte read once, each output written once:
//     z 1 + 4 B, zc 1 + 12 B, pfx 1 + 8 B per position
//     (2^25 positions: 0.050, 0.130 and 0.090 ms);
//   operations at Hopper's 32-bit integer instruction rate, 64 per SM per clock
//     x 132 SMs x the SM clock (16.7 T/s at 1.98 GHz). The least algorithm
//     above costs, in 32-bit instructions per position, a 64-bit operation
//     counting as the 32-bit instructions it takes: split rotations of fwd
//     and rev 6 each (two 32-bit shifts or funnels, masks and a merge per
//     33/31 part); the two 3-input XORs 2 each; four seed picks by code,
//     2 each (one 32-bit load or select per half); the 64-bit canonical
//     add 2; byte load and code/start extraction 2; validity 3 (update the
//     last key, compare); the prefix and the suffix rmin 5 each (64-bit
//     compare 2, three selects) and the final combine 5; the segment offset
//     counter 2; clean 2; sentinel test and z 3; the output store 1: 50
//     for z and zc, 54 for pfx (max, compare, add, store of its scans).
//     2^25 positions: ~0.100 ms for z and zc, ~0.108 ms for pfx.
//   So operations bound z and pfx and bytes bound zc. The hashing of the
//   halo (w-1 positions per tile) and the block scans' fixed cost come on
//   top of that least count.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kModeZ = 0;
constexpr int kModeZc = 1;
constexpr int kModePfx = 2;
constexpr unsigned long long kSentinel = ~0ull;
constexpr unsigned long long kM33 = (1ull << 33) - 1;
constexpr unsigned long long kM31 = (1ull << 31) - 1;

// Shared-memory carve-up of one CTA, byte offsets (host and device).
struct Layout {
    int nh;          // hashed positions, T + w - 1
    int run;         // positions per thread, odd
    long long zs;    // int32[T]   z of the tile's outputs
    long long hs;    // u64[nh]    hashes; lrank int32[T] in pfx mode at the end
    long long tabs;  // u64[2][k][4] rotated seed tables
    long long scr;   // u64[8], int32[8], int32[8]: scan scratch
    long long cs;    // u8[nh+k-1+8] staged bytes, word-aligned from 3 bytes before
    long long sidx;  // int16[nh]  suffix argmin index, -1 = none
    long long blk;   // u8[nh]     bit 0 invalid k-mer, bit 1 record start
    long long total;
};

__host__ __device__ inline Layout layout(int k, int w, int tile) {
    Layout L;
    L.nh = tile + w - 1;
    L.run = ((L.nh + kThreads - 1) / kThreads) | 1;
    long long o = 0;
    L.zs = o;   o += 4LL * tile;
    L.hs = o;   o += 8LL * L.nh;
    L.tabs = o; o += 64LL * k;
    L.scr = o;  o += 16LL * kWarps;
    L.cs = o;   o += (L.nh + k - 1 + 8 + 3) & ~3LL;
    L.sidx = o; o += 2LL * L.nh;
    L.blk = o;  o += L.nh;
    L.total = o;
    return L;
}

__device__ __forceinline__ unsigned long long srol1(unsigned long long x) {
    unsigned long long lo = x & kM33, hi = x >> 33;
    lo = ((lo << 1) | (lo >> 32)) & kM33;
    hi = ((hi << 1) | (hi >> 30)) & kM31;
    return (hi << 33) | lo;
}

__device__ __forceinline__ unsigned long long sror1(unsigned long long x) {
    unsigned long long lo = x & kM33, hi = x >> 33;
    lo = ((lo >> 1) | (lo << 32)) & kM33;
    hi = ((hi >> 1) | (hi << 30)) & kM31;
    return (hi << 33) | lo;
}

// x[c] for c in 0..3.
__device__ __forceinline__ unsigned long long pick(const unsigned long long (&x)[4], unsigned c) {
    unsigned long long lo = (c & 1u) ? x[1] : x[0];
    unsigned long long hi = (c & 1u) ? x[3] : x[2];
    return (c & 2u) ? hi : lo;
}

// (hash, local index); index -1 with the all-ones hash is "none".
struct Arg {
    unsigned long long h;
    int i;
};

// Rightmost argmin of l and r, with l left of r: r wins ties.
__device__ __forceinline__ Arg rmin(Arg l, Arg r) { return r.h <= l.h ? r : l; }

// Block-wide exclusive segmented rightmost-argmin scan over one aggregate
// per thread, in thread order (kRev: reverse thread order). `head`: the
// thread's run holds a segment head in scan order, so nothing earlier in
// scan order flows past it. Returns the carry into the thread's run.
template <bool kRev>
__device__ Arg seg_exclusive(Arg x, bool head, unsigned long long* sh_h, int* sh_i, int* sh_f) {
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    const int vl = kRev ? 31 - lane : lane;
    const int vw = kRev ? kWarps - 1 - wid : wid;
    // a earlier in scan order than b: a is left of b, or right when kRev
    auto join = [](Arg a, Arg b) { return kRev ? rmin(b, a) : rmin(a, b); };
    auto from = [](auto v, int o) {
        return kRev ? __shfl_down_sync(0xffffffffu, v, o) : __shfl_up_sync(0xffffffffu, v, o);
    };
    Arg v = x;
    int f = head;
    for (int o = 1; o < 32; o <<= 1) {
        Arg t{from(v.h, o), from(v.i, o)};
        int tf = from(f, o);
        if (vl >= o) {
            if (!f) v = join(t, v);
            f |= tf;
        }
    }
    Arg e{from(v.h, 1), from(v.i, 1)};
    int ef = from(f, 1);
    if (vl == 0) {
        e = Arg{kSentinel, -1};
        ef = 0;
    }
    if (vl == 31) {
        sh_h[vw] = v.h;
        sh_i[vw] = v.i;
        sh_f[vw] = f;
    }
    __syncthreads();
    if (!ef) {
        Arg c{kSentinel, -1};
        for (int u = 0; u < vw; ++u) {
            Arg a{sh_h[u], sh_i[u]};
            c = sh_f[u] ? a : join(c, a);
        }
        e = join(c, e);
    }
    __syncthreads();  // the scratch is reused by the next scan
    return e;
}

// Block-wide exclusive scan of one value per thread (max when !kAdd, sum
// when kAdd); `identity` for thread 0. `sh` holds >= kWarps ints.
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
        int s = lane < kWarps ? sh[lane] : identity;
        for (int o = 1; o < 32; o <<= 1) {
            int t = __shfl_up_sync(0xffffffffu, s, o);
            if (lane >= o) s = kAdd ? s + t : max(s, t);
        }
        if (lane < kWarps) sh[lane] = s;
    }
    __syncthreads();
    int before = wid > 0 ? sh[wid - 1] : identity;
    __syncthreads();  // sh is reused by the next scan
    return kAdd ? before + excl : max(before, excl);
}

// 16-byte copy of int32 src[0, tile) to dst[t0, ...), stopping at n.
__device__ __forceinline__ void store_tile(int32_t* __restrict__ dst, const int32_t* src,
                                           long long t0, int tile, long long n) {
    for (int j = 4 * threadIdx.x; j < tile; j += 4 * kThreads) {
        long long p = t0 + j;
        if (p + 3 < n) {
            *reinterpret_cast<int4*>(dst + p) = *reinterpret_cast<const int4*>(src + j);
        } else {
            for (int u = 0; u < 4 && p + u < n; ++u) dst[p + u] = src[j + u];
        }
    }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
phase1_kernel(const uint8_t* __restrict__ codes, long long n, int k, int w,
              int tile, const unsigned long long* __restrict__ tabs,
              int32_t* __restrict__ z, long long* __restrict__ canon,
              int32_t* __restrict__ lrank) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Layout lay = layout(k, w, tile);
    const int nh = lay.nh;
    const int nc = nh + k - 1;
    int32_t* zs = reinterpret_cast<int32_t*>(smem + lay.zs);
    unsigned long long* hs = reinterpret_cast<unsigned long long*>(smem + lay.hs);
    unsigned long long* ftab = reinterpret_cast<unsigned long long*>(smem + lay.tabs);
    unsigned long long* rtab = ftab + 4 * k;
    unsigned long long* sh_h = reinterpret_cast<unsigned long long*>(smem + lay.scr);
    int* sh_i = reinterpret_cast<int*>(sh_h + kWarps);
    int* sh_f = sh_i + kWarps;
    int16_t* sidx = reinterpret_cast<int16_t*>(smem + lay.sidx);
    uint8_t* blk = smem + lay.blk;

    const long long t0 = (long long)blockIdx.x * tile;
    const long long base = t0 - (w - 1);   // stream position of local index 0

    // stage the bytes as the words of `codes` that hold them: cs[i] is
    // stream byte base + i, and cs - lead is word-aligned
    const int lead = (int)(reinterpret_cast<uintptr_t>(codes + base) & 3);
    uint8_t* cs = smem + lay.cs + lead;
    uint32_t* cw = reinterpret_cast<uint32_t*>(smem + lay.cs);
    for (int wi = threadIdx.x; wi < (nc + lead + 3) / 4; wi += kThreads) {
        const long long q0 = base - lead + 4LL * wi;
        uint32_t v;
        if (q0 >= 0 && q0 + 3 < n) {
            v = *reinterpret_cast<const uint32_t*>(codes + q0);
        } else {
            v = 0;
            for (int b = 0; b < 4; ++b) {
                const long long q = q0 + b;
                v |= (uint32_t)((q >= 0 && q < n) ? codes[q] : 255) << (8 * b);
            }
        }
        cw[wi] = v;
    }
    for (int i = threadIdx.x; i < 8 * k; i += kThreads) ftab[i] = tabs[i];
    __syncthreads();

    // rolling seeds: S[c] = SEED[c], RK[c] = srol^k(SEED[c]); the reverse
    // strand's are S[3-c] and RK[3-c]
    unsigned long long S[4], RK[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        S[c] = ftab[4 * (k - 1) + c];
        RK[c] = srol1(ftab[c]);
    }

    // 1. hash the run [s, e), fold both scans' aggregates and the last blocker
    const int s = threadIdx.x * lay.run;
    const int e = min(s + lay.run, nh);
    Arg fagg{kSentinel, -1}, ragg{kSentinel, -1};
    bool fhead = false, rhead = false;
    int last_blk = -1;
    if (s < e) {
        unsigned long long f = 0, r = 0;
        int last = -1;  // key of the last byte blocking a k-mer: see the header
        for (int j = 0; j < k; ++j) {
            const unsigned c = cs[s + j];
            f ^= ftab[4 * j + (c & 3u)];
            r ^= rtab[4 * j + (c & 3u)];
            last = (c & 63u) > 3u ? s + j : (c & 64u) ? s + j - 1 : last;
        }
        int off = s % w;
        for (int i = s;;) {
            const unsigned c = cs[i];
            const bool valid = last < i;
            const unsigned long long h = f + r;
            hs[i] = h;
            blk[i] = (valid ? 0 : 1) | ((c & 64u) ? 2 : 0);
            if (!valid || (c & 64u)) last_blk = i;
            const Arg a{h, i};
            if (off == 0) {
                fagg = a;
                fhead = true;
            } else {
                fagg = rmin(fagg, a);
            }
            if (!rhead) {
                ragg = rmin(ragg, a);
                rhead = off == w - 1;
            }
            if (++i == e) break;
            off = off == w - 1 ? 0 : off + 1;
            // roll from the k-mer at i-1 to the one at i
            const unsigned cl = c & 3u, cin = cs[i + k - 1], ce = cin & 3u;
            f = srol1(f) ^ pick(RK, cl) ^ pick(S, ce);
            r = sror1(r ^ pick(S, cl ^ 3u) ^ pick(RK, ce ^ 3u));
            last = (cin & 63u) > 3u ? i + k - 1 : (cin & 64u) ? i + k - 2 : last;
        }
    }

    // 2. carries into each run: prefix from the left, suffix from the
    // right, last blocker before s
    const Arg fcarry = seg_exclusive<false>(fagg, fhead, sh_h, sh_i, sh_f);
    const Arg rcarry = seg_exclusive<true>(ragg, rhead, sh_h, sh_i, sh_f);
    int lb = block_exclusive<false>(last_blk, -1, sh_f);

    // 3. suffix argmin of every position of the run, right to left
    if (s < e) {
        Arg sfx = rcarry;
        int off = (e - 1) % w;
        for (int i = e - 1; i >= s; --i) {
            const Arg a{hs[i], i};
            sfx = off == w - 1 ? a : rmin(a, sfx);
            sidx[i] = (int16_t)sfx.i;
            off = off == 0 ? w - 1 : off - 1;
        }
    }
    __syncthreads();

    // 4. prefix argmin, left to right, and z of the window ending at each
    // position i >= w-1 of the run: output j = i-(w-1), window [j, i]
    int zmax = -1;
    if (s < e) {
        Arg pfx = fcarry;
        int off = s % w;
        for (int i = s; i < e; ++i) {
            pfx = off == 0 ? Arg{hs[i], i} : rmin(pfx, Arg{hs[i], i});
            if (blk[i]) lb = i;
            off = off == w - 1 ? 0 : off + 1;
            const int j = i - (w - 1);
            if (j < 0) continue;
            const int si = sidx[j];
            const Arg best = rmin(Arg{si >= 0 ? hs[si] : kSentinel, si}, pfx);
            const int32_t zj = (lb < j && best.h != kSentinel) ? (int32_t)(base + best.i) : -1;
            zs[j] = zj;
            zmax = max(zmax, zj);
        }
    }

    if (kMode != kModePfx) {
        __syncthreads();
        store_tile(z, zs, t0, tile, n);
        if (kMode == kModeZc) {
            for (int j = threadIdx.x; j < tile && t0 + j < n; j += kThreads) {
                const int i = j + w - 1;
                canon[t0 + j] = (blk[i] & 1) ? 0 : (long long)hs[i];
            }
        }
        return;
    }

    // tile-local prefix-max and increase count over this thread's outputs
    // [js, je); zs past n holds -1 (those positions are blockers)
    const int js = max(s - (w - 1), 0);
    const int je = max(e - (w - 1), js);
    const int before = block_exclusive<false>(zmax, -1, sh_f);  // zpfx[js-1], -1 at 0
    int m = before, cnt = 0;
    for (int j = js; j < je; ++j) {
        const int v = max(m, zs[j]);
        cnt += v > m;
        m = v;
        zs[j] = v;
    }
    int acc = block_exclusive<true>(cnt, 0, sh_f);
    int32_t* ls = reinterpret_cast<int32_t*>(hs);  // every read of hs is done
    m = before;
    for (int j = js; j < je; ++j) {
        acc += zs[j] > m;
        m = zs[j];
        ls[j] = acc;
    }
    __syncthreads();
    const long long all = t0 + tile;  // zpfx and lrank cover whole tiles
    store_tile(z, zs, t0, tile, all);
    store_tile(lrank, ls, t0, tile, all);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA (every mode uses the same layout; `mode`
// is 0 z, 1 zc, 2 pfx); the Python wrapper checks it against the card's
// per-block limit before launching.
long long phase1_smem_bytes(int k, int w, int tile, int mode) {
    (void)mode;
    return layout(k, w, tile).total;
}

}  // extern "C"

namespace {

template <int kMode>
int launch(const void* codes, long long n, int k, int w, int tile,
           const void* tabs, void* z, void* canon, void* lrank, void* stream) {
    if (n <= 0) return 0;
    // 16-byte stores of z and lrank; int16 suffix indices
    if (tile % kThreads != 0 || reinterpret_cast<uintptr_t>(z) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(lrank) % 16 != 0 || tile + w - 1 > 32767)
        return (int)cudaErrorInvalidValue;
    long long smem = layout(k, w, tile).total;
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
