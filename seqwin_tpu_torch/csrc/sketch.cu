// Device MinHash sketches on Hopper (sm_90a): hash every base of a chunk of
// assembly streams once, keep only the hashes under a per-assembly cut, and
// select each assembly's bottom-k from what was kept. Two launch entries:
//   sketch_cut    one launch a chunk: the candidates of every assembly in it;
//   sketch_select one launch a job: each assembly's least distinct values.
//
// New in the port; it replaces no TPU kernel. The JAX package computes the
// sketches with XLA ops (seqwin_tpu/mash.py::device_sketches). The plain
// versions of the two kernels are mash.py's sketch_cut_plain and
// sketch_select_plain; the torch path that computes every sketch without
// the cut (`_sketch_torch`) is the exact fallback of an assembly the cut
// cannot settle.
//
// A chunk is a uint8 stream of whole assemblies; an assembly's stream is its
// records joined by one 255 byte (codes 0..3 are ACGT, anything above 3 is
// invalid). `rows` holds one int64[4] row per assembly of the chunk:
//   off   the assembly's first byte in the chunk,
//   len   its stream length,
//   tile0 its first block in the chunk's grid (blocks are kTile positions of
//         one assembly each, so an assembly has ceil(len / kTile) of them),
//   tau   the cut, a uint64: a valid k-mer's hash h is kept iff h < tau
//         (unsigned and strict, so the all-ones value never enters).
// The k-mer at position q of an assembly is valid iff its k bytes lie in
// [0, len) and are all <= 3; bytes outside the assembly read as 255, so no
// k-mer crosses into the next one whatever lies between them. Its hash is
// the canonical ntHash v2 (forward + reverse complement, each the XOR of the
// k seeds split-rotated by their offset), the function of
// engine/minimizer.py::canon_hashes and of kernel B1's rolling hash.
//
// sketch_cut: one CTA of 256 threads a tile of kTile positions of one
// assembly. Thread 0 finds the tile's assembly by a binary search over
// tile0. The CTA stages the tile's bytes and their k-1 halo in shared memory
// as 4-byte words; thread t then rolls the hash along its run of kRun
// positions [t*kRun, t*kRun + kRun), kRun = 4 x an odd number of words, so
// the 32 threads of a warp read 32 distinct banks at every step. The run's
// first k-mer is hashed from the per-offset seed tables of
// engine/phase1.py::rot_seed_tables, the rest roll in 64-bit arithmetic as
// in B1 (csrc/phase1.cu, whose helpers srol1, sror1 and pick are copied
// here unchanged):
//   fwd(q+1) = srol(fwd(q)) ^ srol^k(SEED[c_q]) ^ SEED[c_{q+k}]
//   rev(q+1) = sror(rev(q) ^ SEED_COMP[c_q] ^ srol^k(SEED_COMP[c_{q+k}]))
// with an invalid byte taking the seeds of its low two bits: the recurrence
// stays exact once it has left the k-mer, and a k-mer holding it is
// invalid. Validity follows the last invalid byte seen. A kept hash goes to
// the assembly's slot of `cand` (cap entries) at an index taken with one
// atomicAdd on the assembly's counter per group of lanes that keep a value
// in the same step (warp-aggregated); past cap only the counter grows, and
// the host redoes that assembly in full.
//
// sketch_select: one CTA of 1024 threads an assembly. It loads the
// assembly's min(counter, cap) candidates into shared memory, sorts them
// with a bitonic network whose every comparator puts the smaller value at
// the lower index (the first stage of each merge compares mirrored pairs),
// so the slots from n up to the next power of two act as +infinity and are
// never touched; marks the first of each run of equal values, ranks the
// marks with a block-wide scan, and writes row a of `out`, int64[A, size+2]:
// [0, size) the least `size` distinct values ascending, all-ones past the
// distinct count; [size] the distinct count; [size+1] the raw counter.
//
// Bounds on the H100: the sketches' least work (portbench/sketch_peaks.py)
// is 1 byte and 34 32-bit instructions a base, the rolling hash of B1 with
// validity and the compare against the cut: the instruction rate bounds it,
// 2.03 ns a kilobase (1.63 ms over the 803.7 Mbp of the benchmark's
// 171-assembly set). This kernel spends per position two shared byte loads,
// the roll, the 64-bit add and compare, and the validity test; per run of
// kRun positions k table reads to start the hash, and per tile the staging
// and one binary search. The cut keeps about 4 x size values an assembly,
// so the kept values' atomics and stores and the select's sort are a small
// fraction of the hashing. The copy of the chunk to the device, 1 byte a
// position over PCIe, is the path's longer leg.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 60;                  // positions a thread: 15 words
constexpr int kTile = kThreads * kRun;    // positions a CTA of sketch_cut
constexpr int kSelectThreads = 1024;
constexpr unsigned long long kM33 = (1ull << 33) - 1;
constexpr unsigned long long kM31 = (1ull << 31) - 1;

// Dynamic shared memory of a sketch_cut CTA: the seed tables u64[2][k][4],
// then the staged bytes (kTile + k - 1, up to 3 leading alignment bytes).
__host__ __device__ inline long long cut_smem(int k) {
    return 64LL * k + ((kTile + k - 1 + 3 + 3) & ~3LL);
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

__global__ void __launch_bounds__(kThreads)
sketch_cut_kernel(const uint8_t* __restrict__ codes, int k,
                  const unsigned long long* __restrict__ tabs,
                  const long long* __restrict__ rows, int n_asm,
                  unsigned long long* __restrict__ cand,
                  unsigned* __restrict__ counts, int cap) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int s_asm;
    unsigned long long* ftab = reinterpret_cast<unsigned long long*>(smem);
    unsigned long long* rtab = ftab + 4 * k;

    const int b = blockIdx.x;
    if (threadIdx.x == 0) {
        int lo = 0, hi = n_asm - 1;  // the last assembly whose first tile is <= b
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (rows[4 * mid + 2] <= b) lo = mid; else hi = mid - 1;
        }
        s_asm = lo;
    }
    for (int i = threadIdx.x; i < 8 * k; i += kThreads) ftab[i] = tabs[i];
    __syncthreads();

    const int a = s_asm;
    const uint8_t* src = codes + rows[4 * a];
    const long long len = rows[4 * a + 1];
    const long long t0 = (long long)(b - rows[4 * a + 2]) * kTile;  // in the assembly
    const unsigned long long tau = (unsigned long long)rows[4 * a + 3];

    // stage bytes [t0, t0 + kTile + k - 1) of the assembly as the words of
    // `codes` that hold them: cs[i] is byte t0 + i, and cs - lead is
    // word-aligned; bytes outside [0, len) read as 255
    const int nc = kTile + k - 1;
    const int lead = (int)(reinterpret_cast<uintptr_t>(src + t0) & 3);
    uint32_t* cw = reinterpret_cast<uint32_t*>(smem + 64LL * k);
    const uint8_t* cs = reinterpret_cast<const uint8_t*>(cw) + lead;
    for (int wi = threadIdx.x; wi < (nc + lead + 3) / 4; wi += kThreads) {
        const long long q0 = t0 - lead + 4LL * wi;
        uint32_t v;
        if (q0 >= 0 && q0 + 3 < len) {
            v = *reinterpret_cast<const uint32_t*>(src + q0);
        } else {
            v = 0;
            for (int u = 0; u < 4; ++u) {
                const long long q = q0 + u;
                v |= (uint32_t)((q >= 0 && q < len) ? src[q] : 255) << (8 * u);
            }
        }
        cw[wi] = v;
    }
    __syncthreads();

    // rolling seeds: S[c] = SEED[c], RK[c] = srol^k(SEED[c]); the reverse
    // strand's are S[3-c] and RK[3-c]
    unsigned long long S[4], RK[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        S[c] = ftab[4 * (k - 1) + c];
        RK[c] = srol1(ftab[c]);
    }

    const int s = threadIdx.x * kRun;
    unsigned long long f = 0, r = 0;
    int last = -1;  // the last invalid byte at or before the k-mer's end
    for (int j = 0; j < k; ++j) {
        const unsigned c = cs[s + j];
        f ^= ftab[4 * j + (c & 3u)];
        r ^= rtab[4 * j + (c & 3u)];
        if (c > 3u) last = s + j;
    }
    const unsigned lanes_below = (1u << (threadIdx.x & 31)) - 1;
    unsigned* count = counts + a;
    unsigned long long* slot = cand + (long long)a * cap;
    for (int i = s;;) {
        const unsigned long long h = f + r;
        if (last < i && h < tau) {
            // the lanes keeping a value in this step share one atomicAdd
            const unsigned group = __activemask();
            const unsigned rank = __popc(group & lanes_below);
            unsigned base = 0;
            if (rank == 0) base = atomicAdd(count, (unsigned)__popc(group));
            const unsigned idx = __shfl_sync(group, base, __ffs(group) - 1) + rank;
            if (idx < (unsigned)cap) slot[idx] = h;
        }
        if (++i == s + kRun) break;
        // roll from the k-mer at i-1 to the one at i
        const unsigned cl = cs[i - 1] & 3u, cin = cs[i + k - 1], ce = cin & 3u;
        f = srol1(f) ^ pick(RK, cl) ^ pick(S, ce);
        r = sror1(r ^ pick(S, cl ^ 3u) ^ pick(RK, ce ^ 3u));
        if (cin > 3u) last = i + k - 1;
    }
}

// Block-wide exclusive sum of one value a thread (kSelectThreads threads);
// `sh` holds 32 ints.
__device__ int block_exclusive_sum(int x, int* sh) {
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    int v = x;
    for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += t;
    }
    if (lane == 31) sh[wid] = v;
    __syncthreads();
    if (wid == 0) {
        int w = sh[lane];
        for (int o = 1; o < 32; o <<= 1) {
            const int t = __shfl_up_sync(0xffffffffu, w, o);
            if (lane >= o) w += t;
        }
        sh[lane] = w;
    }
    __syncthreads();
    return (wid > 0 ? sh[wid - 1] : 0) + v - x;
}

__device__ __forceinline__ void cswap(unsigned long long* x, int i, int j) {
    const unsigned long long a = x[i], b = x[j];
    if (b < a) {
        x[i] = b;
        x[j] = a;
    }
}

__global__ void __launch_bounds__(kSelectThreads)
sketch_select_kernel(const unsigned long long* __restrict__ cand,
                     const unsigned* __restrict__ counts, int cap, int size,
                     long long* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int sh[32];
    __shared__ int s_distinct;
    unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
    const int tid = threadIdx.x;
    const int a = blockIdx.x;
    const unsigned count = counts[a];
    const int n = (int)min(count, (unsigned)cap);
    const unsigned long long* src = cand + (long long)a * cap;
    for (int i = tid; i < n; i += kSelectThreads) keys[i] = src[i];
    __syncthreads();

    int pw = 1;
    while (pw < n) pw <<= 1;
    for (int width = 2; width <= pw; width <<= 1) {
        const int half = width >> 1;
        for (int p = tid; p < pw / 2; p += kSelectThreads) {
            const int base = (p / half) * width, o = p % half;
            if (base + width - 1 - o < n) cswap(keys, base + o, base + width - 1 - o);
        }
        __syncthreads();
        for (int st = half >> 1; st > 0; st >>= 1) {
            for (int p = tid; p < pw / 2; p += kSelectThreads) {
                const int i = (p / st) * 2 * st + p % st;
                if (i + st < n) cswap(keys, i, i + st);
            }
            __syncthreads();
        }
    }

    // rank the first of each run of equal values; thread t takes [lo, hi)
    const int per = (n + kSelectThreads - 1) / kSelectThreads;
    const int lo = min(n, tid * per), hi = min(n, lo + per);
    int firsts = 0;
    for (int i = lo; i < hi; ++i) firsts += (i == 0 || keys[i] != keys[i - 1]);
    int rank = block_exclusive_sum(firsts, sh);
    long long* row = out + (long long)a * (size + 2);
    for (int i = lo; i < hi; ++i) {
        if (i == 0 || keys[i] != keys[i - 1]) {
            if (rank < size) row[rank] = (long long)keys[i];
            ++rank;
        }
    }
    if (tid == kSelectThreads - 1) {  // the last thread's rank is the distinct count
        s_distinct = rank;
        row[size] = rank;
        row[size + 1] = count;
    }
    __syncthreads();
    for (int i = s_distinct + tid; i < size; i += kSelectThreads) row[i] = -1;
}

}  // namespace

extern "C" {

// Positions a sketch_cut CTA takes; the wrapper plans its tiles with it.
int sketch_cut_tile() { return kTile; }

// Dynamic shared memory of a sketch_cut CTA for k; the wrapper checks it
// against the card's per-block limit before launching.
long long sketch_cut_smem_bytes(int k) { return cut_smem(k); }

// Each entry launches on `stream` and returns cudaGetLastError() of the
// launch (0 = ok).

// Candidates of a chunk's n_asm assemblies over `blocks` CTAs: `tabs` the
// int64[2, k, 4] rotated seed table, `rows` int64[n_asm, 4], `cand`
// uint64[n_asm, cap], `counts` uint32[n_asm] (zeroed before the first chunk
// that adds to them).
int sketch_cut_launch(const void* codes, int k, const void* tabs, const void* rows,
                      int n_asm, long long blocks, void* cand, void* counts, int cap,
                      void* stream) {
    if (blocks <= 0) return 0;
    if (k < 1 || n_asm < 1 || cap < 1 || blocks > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const long long smem = cut_smem(k);
    cudaError_t err = cudaFuncSetAttribute(
        sketch_cut_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    sketch_cut_kernel<<<(unsigned)blocks, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, k, (const unsigned long long*)tabs, (const long long*)rows,
        n_asm, (unsigned long long*)cand, (unsigned*)counts, cap);
    return (int)cudaGetLastError();
}

// Row a of `out` int64[n_asm, size + 2] from assembly a's candidates.
int sketch_select_launch(const void* cand, const void* counts, int n_asm, int cap, int size,
                         void* out, void* stream) {
    if (n_asm <= 0) return 0;
    if (cap < 1 || size < 1) return (int)cudaErrorInvalidValue;
    const long long smem = 8LL * cap;
    cudaError_t err = cudaFuncSetAttribute(
        sketch_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    sketch_select_kernel<<<(unsigned)n_asm, kSelectThreads, (size_t)smem,
                           (cudaStream_t)stream>>>(
        (const unsigned long long*)cand, (const unsigned*)counts, cap, size, (long long*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
