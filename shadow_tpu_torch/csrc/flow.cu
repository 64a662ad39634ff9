// The window chunk's device control flow and its two reductions.
//
// Built by shadow_tpu_torch/core/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -cudart shared
// and bound with ctypes (a plain C interface, no PyTorch headers). Every
// function returns a cudaError_t as int (0: success); the Python wrappers
// raise on anything else.
//
// 1. Capture helpers (sf_capture_*, sf_handle, sf_set_cond, sf_node_*):
//    the port's counterpart of the reference's lax.while_loop/lax.cond
//    inside one compiled chunk (shadow_tpu/engine/window.py
//    _run_windows_impl). A WHILE or IF conditional node is added to the
//    graph being captured on a stream, and its body is captured on a
//    second stream (cudaStreamBeginCaptureToGraph), as PyTorch's
//    CUDAGraph::begin_capture_to_if_node does for IF; PyTorch has no
//    WHILE capture. The node's handle is set on the device by a kernel
//    (sf_set_cond), by the pass-flags kernel or by the advance kernel.
//
// 2. Kernels. The JAX package has no Pallas kernel, so these replace
//    none: they are the reductions the chunk needs on the device so that
//    the host reads nothing inside it.
//    - pass_flags: which dispatch codes, TCP parts and CPU-model bits any
//      row of a drain pass holds, and whether the pass loop goes on; it
//      sets the pass loop's handle. Reads the [H] code and feature words
//      once (8 bytes a row). Plain version: core/kernels.py:
//      pass_flags_plain.
//    - advance: the window boundary's min over eq_next and ob_next and
//      sum over ob_cnt (up to 20 bytes a row), then the reference's
//      advance on the window scalars (next [ws, we) with the
//      anti-livelock rule, clamped to the stop time; the window counter;
//      the next window's ran flag) and the window loop's handle. Plain
//      version: core/kernels.py:advance_plain.
//    - advance_lanes: advance over B stacked scenario lanes ([B * H] rows,
//      row r in lane r / H; W is [B, W_LEN], a row a lane), each lane's
//      boundary exactly as advance's for one lane, a lane whose go-on flag
//      is 0 left as it is (jax's batched while_loop freezes a finished
//      lane), and the batch's row G (the OR of the lanes' go-on flags,
//      whether some live lane ships) with the window loop's handle set
//      from it. Plain version: core/kernels.py:advance_lanes_plain.
//    What bounds them: bytes, ~0.24 us and ~0.6 us at H = 100,000 on
//    3.35 TB/s; in practice one graph node's launch (~1 us for an empty
//    kernel in a graph) and a few dependent memory round trips, as both
//    run once a pass or a window inside the captured chunk. As first
//    written, each was one block of 1,024 threads that walked ~98 rows a
//    thread with one 4- or 8-byte load each: one SM's load latency times
//    that loop, 34-110x the bound. Now each is one launch of a block per
//    ROWS_PER_BLOCK rows (a power of two, at most CLUSTER), the blocks one
//    thread-block cluster on as many SMs when there are several:
//    - every thread issues all its loads before it reduces any: 16-byte
//      vectors, UNROLL of each array at a time, and the head and tail
//      rows (a view may start off a 16-byte boundary; H is any count),
//      with rows a thread does not have read from an identity instead
//      of under a branch;
//    - warps reduce with __reduce_or_sync or shuffles, then warp 0 a
//      block's warps from shared memory; the other warps exit;
//    - warp 0 of each other block sends the block's part into rank 0's
//      shared memory (distributed shared memory) with st.async, which
//      signals an mbarrier there as the bytes land: one cluster barrier
//      (arrived at as the kernel starts, waited on once the rows are
//      reduced) and a one-way message a block;
//    - rank 0's warp 0 waits on its mbarrier, reduces the parts, writes
//      the result, sets the handle and counts the execution (an atomic
//      nothing waits for); advance reads W with the rows, not after them.
//    No second pass, no scratch, no memset: the chunk's capture is
//    unchanged. Integer arithmetic only, so the bits equal the plain
//    versions'. 16 blocks is a non-portable cluster size, measured faster
//    than 8 at 100,000 rows; 2,048 rows a block (two blocks at 4,096
//    rows) measured faster than 4,096 at 10,000 rows and within 2% at
//    4,096 (PERF.md, section 6).

#include <cuda_runtime.h>
#include <stdint.h>

#define SIMTIME_MAX 0x7FFFFFFFFFFFFFFFLL
#define MAX_CODES 128
#define CLUSTER 16              // the most blocks: one cluster
#define ROWS_PER_BLOCK 2048
#define THREADS 256
#define WARPS (THREADS / 32)

// the window-scalar vector W (int64), engine/window.py's W_* indices
enum { W_WS = 0, W_WE, W_I, W_PASSES, W_WEFF, W_RAN, W_OB0, W_CONT,
       W_STOP, W_JUMP, W_MAXW, W_EX, W_LEN };
enum { ADV_OPEN = 0, ADV_SHIP = 1, ADV_STEP = 2 };

static cudaStream_t S(void *p) { return (cudaStream_t)p; }

// executions of each kernel on the device (a captured chunk runs them
// many times for each wrapper call): [0] pass_flags, [1] advance,
// [2] advance_lanes
__device__ unsigned long long exec_count[3];

extern "C" int sf_exec_counts(unsigned long long *out, int reset) {
    cudaError_t e = cudaMemcpyFromSymbol(out, exec_count,
                                         sizeof(exec_count));
    if (e != cudaSuccess || !reset) return e;
    unsigned long long zero[3] = {0, 0, 0};
    return cudaMemcpyToSymbol(exec_count, zero, sizeof(zero));
}

// --- capture ---------------------------------------------------------------

extern "C" int sf_capture_begin(void *stream) {
    return cudaStreamBeginCapture(S(stream),
                                  cudaStreamCaptureModeRelaxed);
}

extern "C" int sf_capture_end(void *stream, void **graph) {
    cudaGraph_t g = nullptr;
    cudaError_t e = cudaStreamEndCapture(S(stream), &g);
    *graph = (void *)g;
    return e;
}

extern "C" int sf_instantiate(void *graph, void **exec) {
    cudaGraphExec_t x = nullptr;
    cudaError_t e = cudaGraphInstantiate(&x, (cudaGraph_t)graph, 0);
    *exec = (void *)x;
    return e;
}

extern "C" int sf_launch(void *exec, void *stream) {
    return cudaGraphLaunch((cudaGraphExec_t)exec, S(stream));
}

extern "C" int sf_destroy(void *graph, void *exec) {
    cudaError_t e = cudaSuccess;
    if (exec) e = cudaGraphExecDestroy((cudaGraphExec_t)exec);
    if (graph) {
        cudaError_t e2 = cudaGraphDestroy((cudaGraph_t)graph);
        if (e == cudaSuccess) e = e2;
    }
    return e;
}

static cudaError_t capture_graph(cudaStream_t s, cudaGraph_t *g,
                                 const cudaGraphNode_t **deps, size_t *nd) {
    cudaStreamCaptureStatus st;
    unsigned long long id;
#if CUDART_VERSION >= 13000
    cudaError_t e = cudaStreamGetCaptureInfo(s, &st, &id, g, deps, nullptr,
                                             nd);
#else
    cudaError_t e = cudaStreamGetCaptureInfo(s, &st, &id, g, deps, nd);
#endif
    if (e != cudaSuccess) return e;
    return st == cudaStreamCaptureStatusActive ? cudaSuccess
                                               : cudaErrorIllegalState;
}

// a conditional handle in the graph being captured on `stream`
extern "C" int sf_handle(void *stream, unsigned long long *h) {
    cudaGraph_t g;
    const cudaGraphNode_t *deps;
    size_t nd;
    cudaError_t e = capture_graph(S(stream), &g, &deps, &nd);
    if (e != cudaSuccess) return e;
    cudaGraphConditionalHandle ch;
    e = cudaGraphConditionalHandleCreate(&ch, g, 0, 0);
    *h = (unsigned long long)ch;
    return e;
}

__global__ void set_cond_k(cudaGraphConditionalHandle h, const void *p,
                           int nbytes, unsigned int cval) {
    unsigned int v = cval;
    if (p) {
        if (nbytes == 8) v = *(const long long *)p != 0;
        else if (nbytes == 4) v = *(const int *)p != 0;
        else v = *(const unsigned char *)p != 0;
    }
    cudaGraphSetConditional(h, v);
}

// handle = (*p != 0), or `cval` when p is null
extern "C" int sf_set_cond(void *stream, unsigned long long h, const void *p,
                           int nbytes, unsigned int cval) {
    set_cond_k<<<1, 1, 0, S(stream)>>>((cudaGraphConditionalHandle)h, p,
                                       nbytes, cval);
    return cudaGetLastError();
}

// add a WHILE (is_while) or IF node on `h` after the work captured so far
// on `stream`, and begin capturing its body on `child`
extern "C" int sf_node_begin(void *stream, void *child, unsigned long long h,
                             int is_while) {
    cudaGraph_t g;
    const cudaGraphNode_t *deps;
    size_t nd;
    cudaError_t e = capture_graph(S(stream), &g, &deps, &nd);
    if (e != cudaSuccess) return e;
    cudaGraphNodeParams p = {};
    p.type = cudaGraphNodeTypeConditional;
    p.conditional.handle = (cudaGraphConditionalHandle)h;
    p.conditional.type = is_while ? cudaGraphCondTypeWhile
                                  : cudaGraphCondTypeIf;
    p.conditional.size = 1;
    cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
    e = cudaGraphAddNode(&node, g, deps, nullptr, nd, &p);
    if (e != cudaSuccess) return e;
    e = cudaStreamUpdateCaptureDependencies(S(stream), &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
    e = cudaGraphAddNode(&node, g, deps, nd, &p);
    if (e != cudaSuccess) return e;
    e = cudaStreamUpdateCaptureDependencies(S(stream), &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
    if (e != cudaSuccess) return e;
    return cudaStreamBeginCaptureToGraph(S(child), p.conditional.phGraph_out[0],
                                         nullptr, nullptr, 0,
                                         cudaStreamCaptureModeRelaxed);
}

extern "C" int sf_node_end(void *child) {
    cudaGraph_t g = nullptr;
    return cudaStreamEndCapture(S(child), &g);
}

// the blocks of the two kernels' cluster at H rows: the least power of
// two that gives each block at most ROWS_PER_BLOCK rows, at most CLUSTER
static int blocks_for(int H) {
    int b = 1;
    while (b < CLUSTER && b * ROWS_PER_BLOCK < H) b *= 2;
    return b;
}

// --- the two kernels: one cluster of blocks -------------------------------

// the 16-byte vector of an element type
template <typename T> struct Vec;
template <> struct Vec<int32_t> { using V = int4; };
template <> struct Vec<long long> { using V = longlong2; };

// the rows p[0, n) as thread t of nt reads them: the head before p's first
// 16-byte boundary and the tail after its last whole 16-byte vector (each
// fewer than 16 bytes: row t of either, if it has one), and the vectors
// between them (t, t + nt, ...). p may be a view one element into a
// larger tensor; n may be 0 (p is then never read). A thread reads a row
// it does not have from `none` (a reduction's identity) instead: every
// load is unconditional, so the compiler issues them all before the
// first is used.
template <typename T> struct Rows {
    using V = typename Vec<T>::V;
    static constexpr int PER = 16 / sizeof(T);
    const T *p;
    const V *none;
    int head, nv, tail, ntail;
    __device__ Rows(const T *p_, int n, const V *none_)
        : p(p_), none(none_) {
        head = (int)((16 - ((uintptr_t)p & 15)) & 15) / (int)sizeof(T);
        if (head > n) head = n;
        nv = (n - head) / PER;
        tail = head + nv * PER;
        ntail = n - tail;
    }
    __device__ V vec(int i) const {
        return *(i < nv ? reinterpret_cast<const V *>(p + head) + i : none);
    }
    // row t of the head and of the tail
    __device__ T at_head(int t) const {
        return *(t < head ? p + t : (const T *)none);
    }
    __device__ T at_tail(int t) const {
        return *(t < ntail ? p + tail + t : (const T *)none);
    }
};

// the identities: of OR and sum, of min
__device__ const int4 ZERO32 = {0, 0, 0, 0};
__device__ const longlong2 MAX64 = {SIMTIME_MAX, SIMTIME_MAX};

// vectors of each array a thread loads before it reduces any (at H =
// 100,000 a thread of 16 blocks of 256 has ~6 vectors of an int32 array
// and ~12 of an int64 one)
#define UNROLL 4

// launch `kern` on `blocks` blocks of `threads` threads: one cluster of
// them when there are several (more than 8 is a non-portable cluster
// size, allowed on each launch: the attribute belongs to the current
// device's context)
template <auto kern, typename... A>
static cudaError_t launch(void *stream, int blocks, int threads,
                          A... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.stream = S(stream);
    cudaLaunchAttribute at[1];
    if (blocks > 8) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return e;
    }
    if (blocks > 1) {
        at[0].id = cudaLaunchAttributeClusterDimension;
        at[0].val.clusterDim.x = blocks;
        at[0].val.clusterDim.y = 1;
        at[0].val.clusterDim.z = 1;
        cfg.attrs = at;
        cfg.numAttrs = 1;
    }
    cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
    return e != cudaSuccess ? e : cudaGetLastError();
}

__global__ void empty_k(int) {}

// an empty kernel of `blocks` blocks (one cluster when several) of
// `threads` threads: what a kernel node costs in a graph, beside the two
// kernels (chip_smoke.py phase 30)
extern "C" int sf_empty(void *stream, int blocks, int threads) {
    return launch<empty_k>(stream, blocks, threads, 0);
}

// The hand-off of the blocks' parts to rank 0. Rank 0's thread 0 sets up
// an mbarrier in its shared memory that completes once the other blocks'
// parts (`bytes` in all) have landed, and every thread arrives (relaxed)
// on the cluster barrier as it starts. Once its rows are reduced, each
// thread waits on that barrier: by then every block has started and rank
// 0's mbarrier is there. The other blocks' warp 0 then sends the block's
// part into rank 0's shared memory with st.async, which signals the
// mbarrier as the bytes land, and exits; rank 0's warp 0 waits on the
// mbarrier alone. One cluster barrier, and a one-way message a block.
__device__ __forceinline__ unsigned smem(const void *p) {
    return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void handoff_init(unsigned long long *bar,
                                             unsigned bytes) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem(bar)) : "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem(bar)), "r"(bytes) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}
// rank 0's copy of `*p` (this block's shared memory) = v; signals rank
// 0's copy of `bar`
__device__ __forceinline__ void send(unsigned *p, unsigned v,
                                     unsigned long long *bar) {
    unsigned a, b;
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;" : "=r"(a)
                 : "r"(smem(p)));
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;" : "=r"(b)
                 : "r"(smem(bar)));
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32"
                 " [%0], %1, [%2];" :: "r"(a), "r"(v), "r"(b) : "memory");
}
__device__ __forceinline__ void send(long long *p, long long v,
                                     unsigned long long *bar) {
    unsigned a, b;
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;" : "=r"(a)
                 : "r"(smem(p)));
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;" : "=r"(b)
                 : "r"(smem(bar)));
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64"
                 " [%0], %1, [%2];" :: "r"(a), "l"(v), "r"(b) : "memory");
}
__device__ __forceinline__ void handoff_wait(unsigned long long *bar) {
    unsigned done = 0;
    while (!done)
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.acquire.cluster.shared::cta"
                     ".b64 p, [%1], 0;\n selp.u32 %0, 1, 0, p;\n}"
                     : "=r"(done) : "r"(smem(bar)) : "memory");
}

// --- pass flags ------------------------------------------------------------

// out[c] = some row has code c (c < n_codes); out[n_codes + j] = some row
// has feature bit j (j < n_bits); out[n_codes + n_bits] = the pass loop
// goes on: some row's code is not `null_code` or some row has a bit of
// `cont_mask`, and no row has a bit of `stop_mask`. Sets handle `h` (when
// not 0) to that last value. Codes outside [0, n_codes) are ignored.
//
// Each thread keeps the codes it saw as four 32-bit words in registers
// (MAX_CODES = 128), and its feature bits with its live flag (bit 31) in
// a fifth; warps OR them (__reduce_or_sync), then warp 0 ORs a block's
// warps from shared memory and sends the block's part into rank 0's
// shared memory (distributed shared memory); rank 0's warp 0 ORs the
// parts, and each of its lanes writes its bits of the result.
enum { F_W0 = 0, F_BITS = 4, F_LEN };
#define LIVE 0x80000000u

__global__ void __launch_bounds__(THREADS, 1)
pass_flags_k(const int32_t *__restrict__ code,
             const int32_t *__restrict__ feat, int H, int n_codes,
             int n_bits, int null_code, int cont_mask, int stop_mask,
             int32_t *out, cudaGraphConditionalHandle h) {
    __shared__ unsigned warps[WARPS][F_LEN];
    __shared__ unsigned parts[CLUSTER][F_LEN];  // in rank 0: each block's
    __shared__ unsigned long long bar;           // in rank 0: the hand-off
    int nb = gridDim.x, rank = blockIdx.x;       // the grid is one cluster
    if (nb > 1) {
        if (rank == 0 && threadIdx.x == 0)
            handoff_init(&bar, (nb - 1) * F_LEN * sizeof(unsigned));
        cluster_arrive_relaxed();
    }
    int t = blockIdx.x * THREADS + threadIdx.x, nt = nb * THREADS;
    unsigned v[F_LEN] = {0, 0, 0, 0, 0};
    auto see = [&](int c) {
        unsigned u = (unsigned)c, q = u >> 5;
        unsigned bit = u < (unsigned)n_codes ? 1u << (u & 31) : 0u;
        v[0] |= q == 0 ? bit : 0u;
        v[1] |= q == 1 ? bit : 0u;
        v[2] |= q == 2 ? bit : 0u;
        v[3] |= q == 3 ? bit : 0u;
        v[F_BITS] |= c != null_code ? LIVE : 0u;
    };
    Rows<int32_t> rc(code, H, &ZERO32), rf(feat, feat ? H : 0, &ZERO32);
    // the head and tail rows' loads go out with the vectors'
    bool ch = t < rc.head, ct = t < rc.ntail;
    int c0 = rc.at_head(t), c1 = rc.at_tail(t);
    int f01 = rf.at_head(t) | rf.at_tail(t);
    int nv = rc.nv > rf.nv ? rc.nv : rf.nv;
    for (int i0 = t; i0 < nv; i0 += UNROLL * nt) {
        int4 a[UNROLL], b[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; u++) {
            a[u] = rc.vec(i0 + u * nt);
            b[u] = rf.vec(i0 + u * nt);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; u++) {
            if (i0 + u * nt < rc.nv) {
                see(a[u].x);
                see(a[u].y);
                see(a[u].z);
                see(a[u].w);
            }
            v[F_BITS] |= b[u].x | b[u].y | b[u].z | b[u].w;
        }
    }
    if (ch) see(c0);
    if (ct) see(c1);
    v[F_BITS] |= f01;
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < F_LEN; k++) {
        unsigned x = __reduce_or_sync(0xffffffffu, v[k]);
        if (lane == 0) warps[warp][k] = x;
    }
    __syncthreads();
    if (warp) {
        if (nb > 1) cluster_wait();
        return;
    }
#pragma unroll
    for (int k = 0; k < F_LEN; k++)
        v[k] = __reduce_or_sync(0xffffffffu,
                                lane < WARPS ? warps[lane][k] : 0u);
    if (nb > 1) {
        cluster_wait();
        if (rank) {
            if (lane == 0) {
#pragma unroll
                for (int k = 0; k < F_LEN; k++)
                    send(&parts[rank][k], v[k], &bar);
            }
            return;
        }
        handoff_wait(&bar);
        bool in = lane > 0 && lane < nb;
#pragma unroll
        for (int k = 0; k < F_LEN; k++)
            v[k] |= __reduce_or_sync(0xffffffffu, in ? parts[lane][k] : 0u);
    }
#pragma unroll
    for (int k = 0; k < MAX_CODES / 32; k++)
        if (32 * k + lane < n_codes)
            out[32 * k + lane] = (v[F_W0 + k] >> lane) & 1;
    if (lane < n_bits) out[n_codes + lane] = (v[F_BITS] >> lane) & 1;
    if (lane == 0) {
        atomicAdd(&exec_count[0], 1ull);
        unsigned bits = v[F_BITS] & ~LIVE;
        int cont = ((v[F_BITS] & LIVE) || (bits & cont_mask))
                   && !(bits & stop_mask);
        out[n_codes + n_bits] = cont;
        if (h) cudaGraphSetConditional(h, cont);
    }
}

extern "C" int sf_pass_flags(void *stream, const void *code, const void *feat,
                             int H, int n_codes, int n_bits, int null_code,
                             int cont_mask, int stop_mask, void *out,
                             unsigned long long h) {
    if (n_codes > MAX_CODES || n_bits > 31) return cudaErrorInvalidValue;
    return launch<pass_flags_k>(
        stream, blocks_for(H), THREADS, (const int32_t *)code,
        (const int32_t *)feat, H, n_codes, n_bits, null_code, cont_mask,
        stop_mask, (int32_t *)out, (cudaGraphConditionalHandle)h);
}

// --- advance ---------------------------------------------------------------

__device__ static long long warp_min(long long v) {
    for (int o = 16; o; o >>= 1) {
        long long w = __shfl_xor_sync(0xffffffffu, v, o);
        v = w < v ? w : v;
    }
    return v;
}

__device__ static long long warp_sum(long long v) {
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// open the window W[W_WS, W_WE): whether it runs, its end clamped to the
// stop time, and whether the queues hold an event below that end; `w`
// holds W's values (read with the rows)
__device__ static void open_window(long long *W, const long long *w,
                                   long long minq,
                                   cudaGraphConditionalHandle h) {
    long long ws = w[W_WS];
    int cont = w[W_I] < w[W_MAXW] && ws < w[W_STOP] && ws < SIMTIME_MAX;
    long long weff = w[W_WE] < w[W_STOP] ? w[W_WE] : w[W_STOP];
    W[W_CONT] = cont;
    W[W_WEFF] = weff;
    W[W_RAN] = minq < weff;
    if (h) cudaGraphSetConditional(h, cont);
}

// min of eq_next (ADV_OPEN, ADV_STEP), min of ob_next (ADV_STEP) and sum
// of ob_cnt (ADV_SHIP, ADV_STEP): a mode reads only the rows it uses.
// Warps reduce by shuffles, then warp 0 a block's warps from shared
// memory, and sends the block's part into rank 0's shared memory; rank
// 0's warp 0 reduces the parts and its lane 0 runs the scalar tail.
enum { A_MQ = 0, A_MO, A_SO, A_LEN };

__global__ void __launch_bounds__(THREADS, 1)
advance_k(const long long *__restrict__ eq_next,
          const long long *__restrict__ ob_next,
          const int32_t *__restrict__ ob_cnt, int H, long long *W, int mode,
          cudaGraphConditionalHandle h) {
    __shared__ long long warps[WARPS][A_LEN];
    __shared__ long long parts[CLUSTER][A_LEN];     // in rank 0
    __shared__ long long w[W_LEN];                  // in rank 0: W
    __shared__ unsigned long long bar;              // in rank 0: the hand-off
    int nb = gridDim.x, rank = blockIdx.x;          // the grid is one cluster
    if (nb > 1) {
        if (rank == 0 && threadIdx.x == 0)
            handoff_init(&bar, (nb - 1) * A_LEN * sizeof(long long));
        cluster_arrive_relaxed();
    }
    int t = blockIdx.x * THREADS + threadIdx.x, nt = nb * THREADS;
    // rank 0's warp 0 reads W (a value a lane) with the rows
    long long wl = t < W_LEN ? W[t] : 0;
    Rows<long long> re(eq_next, mode != ADV_SHIP ? H : 0, &MAX64),
        ro(ob_next, mode == ADV_STEP ? H : 0, &MAX64);
    Rows<int32_t> rk(ob_cnt, mode != ADV_OPEN ? H : 0, &ZERO32);
    long long mq = re.at_head(t), mo = ro.at_head(t);
    long long e1 = re.at_tail(t), o1 = ro.at_tail(t);
    long long so = (long long)rk.at_head(t) + rk.at_tail(t);
    mq = e1 < mq ? e1 : mq;
    mo = o1 < mo ? o1 : mo;
    int nv = re.nv > ro.nv ? re.nv : ro.nv;
    nv = rk.nv > nv ? rk.nv : nv;
    for (int i0 = t; i0 < nv; i0 += UNROLL * nt) {
        longlong2 a[UNROLL], b[UNROLL];
        int4 c[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; u++) {
            a[u] = re.vec(i0 + u * nt);
            b[u] = ro.vec(i0 + u * nt);
            c[u] = rk.vec(i0 + u * nt);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; u++) {
            long long x = a[u].x < a[u].y ? a[u].x : a[u].y;
            long long y = b[u].x < b[u].y ? b[u].x : b[u].y;
            mq = x < mq ? x : mq;
            mo = y < mo ? y : mo;
            so += (long long)c[u].x + c[u].y + c[u].z + c[u].w;
        }
    }
    mq = warp_min(mq);
    mo = warp_min(mo);
    so = warp_sum(so);
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
        warps[warp][A_MQ] = mq;
        warps[warp][A_MO] = mo;
        warps[warp][A_SO] = so;
    }
    if (t < W_LEN) w[t] = wl;
    __syncthreads();
    if (warp) {
        if (nb > 1) cluster_wait();
        return;
    }
    bool in = lane < WARPS;
    mq = warp_min(in ? warps[lane][A_MQ] : SIMTIME_MAX);
    mo = warp_min(in ? warps[lane][A_MO] : SIMTIME_MAX);
    so = warp_sum(in ? warps[lane][A_SO] : 0);
    if (nb > 1) {
        cluster_wait();
        if (rank) {
            if (lane == 0) {
                send(&parts[rank][A_MQ], mq, &bar);
                send(&parts[rank][A_MO], mo, &bar);
                send(&parts[rank][A_SO], so, &bar);
            }
            return;
        }
        handoff_wait(&bar);
        in = lane > 0 && lane < nb;
        long long q = warp_min(in ? parts[lane][A_MQ] : SIMTIME_MAX);
        long long o = warp_min(in ? parts[lane][A_MO] : SIMTIME_MAX);
        so += warp_sum(in ? parts[lane][A_SO] : 0);
        mq = q < mq ? q : mq;
        mo = o < mo ? o : mo;
    }
    if (lane) return;
    atomicAdd(&exec_count[1], 1ull);
    if (mode == ADV_SHIP) {
        W[W_OB0] = so;
        W[W_EX] = so > 0;
        return;
    }
    if (mode == ADV_STEP) {
        // anti-livelock: a window that executed nothing and shipped
        // nothing re-opens at the earliest queue event, not at the same
        // carried arrival
        int progressed = w[W_RAN] || so < w[W_OB0];
        long long next = progressed ? (mo < mq ? mo : mq) : mq;
        W[W_WS] = w[W_WS] = next;
        W[W_WE] = w[W_WE] =
            next == SIMTIME_MAX ? SIMTIME_MAX : next + w[W_JUMP];
        W[W_I] = w[W_I] += 1;
    }
    open_window(W, w, mq, h);
}

extern "C" int sf_advance(void *stream, const void *eq_next,
                          const void *ob_next, const void *ob_cnt, int H,
                          void *W, int mode, unsigned long long h) {
    return launch<advance_k>(stream, blocks_for(H), THREADS,
                             (const long long *)eq_next,
                             (const long long *)ob_next,
                             (const int32_t *)ob_cnt, H, (long long *)W, mode,
                             (cudaGraphConditionalHandle)h);
}

// --- advance over stacked lanes ---------------------------------------------

// One block a lane (lane b = blockIdx.x, its rows [b * H, (b + 1) * H)):
// the lane's reductions as advance_k's, by the same loads (the lane's
// rows may start anywhere: Rows takes any alignment), then its thread 0
// runs advance's scalar tail on the lane's row of W, unless the lane is
// frozen (its W_CONT is 0 in ADV_SHIP and ADV_STEP; ADV_OPEN opens every
// lane). The batch's row G is set by the last block to finish, found by
// a ticket (G[W_LEN], an atomic counter the last block puts back to 0):
// each block's thread 0 makes its lane's writes visible (__threadfence)
// before it takes a ticket, and the last block reads every lane's flags
// past L1 (__ldcg), where another lane's stale line could sit beside its
// own row. G[W_CONT] is the OR of the lanes' go-on flags (ADV_OPEN,
// ADV_STEP; it sets handle `h`), G[W_EX] whether some live lane ships
// (ADV_SHIP). A ticket, not a cluster a lane or a second launch: one
// launch, and nothing waits but the last block.
//
// What bounds it: bytes, as advance's (20 B a row at ADV_STEP); a block
// a lane reads its lane alone, so one lane of H rows takes one SM's load
// rate (B = 4 lanes of 4,096 rows: four SMs); simple first, as the
// lanes are few and short on the batch's main path.
__global__ void __launch_bounds__(THREADS)
advance_lanes_k(const long long *__restrict__ eq_next,
                const long long *__restrict__ ob_next,
                const int32_t *__restrict__ ob_cnt, int B, int H,
                long long *W, long long *G, int mode,
                cudaGraphConditionalHandle h) {
    __shared__ long long warps[WARPS][A_LEN];
    __shared__ long long w[W_LEN];
    __shared__ int last;
    __shared__ unsigned flags[WARPS][2];
    int b = blockIdx.x, t = threadIdx.x;
    long long *Wb = W + (long long)b * W_LEN;
    long long base = (long long)b * H;
    long long wl = t < W_LEN ? Wb[t] : 0;
    Rows<long long> re(eq_next + base, mode != ADV_SHIP ? H : 0, &MAX64),
        ro(ob_next + base, mode == ADV_STEP ? H : 0, &MAX64);
    Rows<int32_t> rk(ob_cnt + base, mode != ADV_OPEN ? H : 0, &ZERO32);
    long long mq = re.at_head(t), mo = ro.at_head(t);
    long long e1 = re.at_tail(t), o1 = ro.at_tail(t);
    long long so = (long long)rk.at_head(t) + rk.at_tail(t);
    mq = e1 < mq ? e1 : mq;
    mo = o1 < mo ? o1 : mo;
    int nv = re.nv > ro.nv ? re.nv : ro.nv;
    nv = rk.nv > nv ? rk.nv : nv;
    for (int i0 = t; i0 < nv; i0 += UNROLL * THREADS) {
        longlong2 a[UNROLL], c2[UNROLL];
        int4 c[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; u++) {
            a[u] = re.vec(i0 + u * THREADS);
            c2[u] = ro.vec(i0 + u * THREADS);
            c[u] = rk.vec(i0 + u * THREADS);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; u++) {
            long long x = a[u].x < a[u].y ? a[u].x : a[u].y;
            long long y = c2[u].x < c2[u].y ? c2[u].x : c2[u].y;
            mq = x < mq ? x : mq;
            mo = y < mo ? y : mo;
            so += (long long)c[u].x + c[u].y + c[u].z + c[u].w;
        }
    }
    mq = warp_min(mq);
    mo = warp_min(mo);
    so = warp_sum(so);
    int lane = t & 31, warp = t >> 5;
    if (lane == 0) {
        warps[warp][A_MQ] = mq;
        warps[warp][A_MO] = mo;
        warps[warp][A_SO] = so;
    }
    if (t < W_LEN) w[t] = wl;
    __syncthreads();
    if (warp == 0) {
        bool in = lane < WARPS;
        mq = warp_min(in ? warps[lane][A_MQ] : SIMTIME_MAX);
        mo = warp_min(in ? warps[lane][A_MO] : SIMTIME_MAX);
        so = warp_sum(in ? warps[lane][A_SO] : 0);
        if (lane == 0) {
            if (mode == ADV_OPEN || w[W_CONT]) {
                if (mode == ADV_SHIP) {
                    Wb[W_OB0] = so;
                    Wb[W_EX] = so > 0;
                } else {
                    if (mode == ADV_STEP) {
                        int progressed = w[W_RAN] || so < w[W_OB0];
                        long long next =
                            progressed ? (mo < mq ? mo : mq) : mq;
                        Wb[W_WS] = w[W_WS] = next;
                        Wb[W_WE] = w[W_WE] = next == SIMTIME_MAX
                            ? SIMTIME_MAX : next + w[W_JUMP];
                        Wb[W_I] = w[W_I] += 1;
                    }
                    open_window(Wb, w, mq, 0);
                }
            }
            __threadfence();
            unsigned long long ticket =
                atomicAdd((unsigned long long *)&G[W_LEN], 1ull);
            last = ticket == (unsigned long long)(B - 1);
        }
    }
    __syncthreads();
    if (!last) return;
    // the last block: every lane's writes are visible
    __threadfence();
    unsigned cont = 0, ex = 0;
    for (int k = t; k < B; k += THREADS) {
        const long long *Wk = W + (long long)k * W_LEN;
        unsigned c = __ldcg(Wk + W_CONT) != 0;
        cont |= c;
        ex |= c && __ldcg(Wk + W_EX) != 0;
    }
    cont = __reduce_or_sync(0xffffffffu, cont);
    ex = __reduce_or_sync(0xffffffffu, ex);
    if (lane == 0) {
        flags[warp][0] = cont;
        flags[warp][1] = ex;
    }
    __syncthreads();
    if (t) return;
    for (int k = 1; k < WARPS; k++) {
        cont |= flags[k][0];
        ex |= flags[k][1];
    }
    G[W_LEN] = 0;
    atomicAdd(&exec_count[2], 1ull);
    if (mode == ADV_SHIP) {
        G[W_EX] = ex;
        return;
    }
    G[W_CONT] = cont;
    if (h) cudaGraphSetConditional(h, cont);
}

extern "C" int sf_advance_lanes(void *stream, const void *eq_next,
                                const void *ob_next, const void *ob_cnt,
                                int B, int H, void *W, void *G, int mode,
                                unsigned long long h) {
    if (B < 1 || H < 0) return cudaErrorInvalidValue;
    advance_lanes_k<<<B, THREADS, 0, S(stream)>>>(
        (const long long *)eq_next, (const long long *)ob_next,
        (const int32_t *)ob_cnt, B, H, (long long *)W, (long long *)G, mode,
        (cudaGraphConditionalHandle)h);
    return cudaGetLastError();
}
