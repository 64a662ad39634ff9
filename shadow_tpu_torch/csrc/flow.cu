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
//      row of a drain pass holds, and whether the pass loop goes on. One
//      block; the [H] code and feature words are read once (8 bytes a
//      row): bound by bytes, ~0.3 us at H = 100,000 on 3.35 TB/s, in
//      practice by the one block's latency. It sets the pass loop's
//      handle. Plain version: core/kernels.py:pass_flags_plain.
//    - advance: the window boundary's min over eq_next and ob_next and
//      sum over ob_cnt (20 bytes a row, bound by bytes), then the
//      reference's advance on the window scalars (next [ws, we) with the
//      anti-livelock rule, clamped to the stop time; the window counter;
//      the next window's ran flag) and the window loop's handle. Plain
//      version: core/kernels.py:advance_plain.
//    Both are one block of 1,024 threads that strides over the rows: the
//    rows are at most a few 100,000, and one block saves the second pass
//    a grid-wide reduction would need. Integer arithmetic only, so the
//    bits equal the plain versions'.

#include <cuda_runtime.h>
#include <stdint.h>

#define SIMTIME_MAX 0x7FFFFFFFFFFFFFFFLL
#define THREADS 1024
#define MAX_CODES 128

// the window-scalar vector W (int64), engine/window.py's W_* indices
enum { W_WS = 0, W_WE, W_I, W_PASSES, W_WEFF, W_RAN, W_OB0, W_CONT,
       W_STOP, W_JUMP, W_MAXW, W_EX, W_LEN };
enum { ADV_OPEN = 0, ADV_SHIP = 1, ADV_STEP = 2 };

static cudaStream_t S(void *p) { return (cudaStream_t)p; }

// executions of each kernel on the device (a captured chunk runs them
// many times for each wrapper call): [0] pass_flags, [1] advance
__device__ unsigned long long exec_count[2];

extern "C" int sf_exec_counts(unsigned long long *out, int reset) {
    cudaError_t e = cudaMemcpyFromSymbol(out, exec_count,
                                         sizeof(exec_count));
    if (e != cudaSuccess || !reset) return e;
    unsigned long long zero[2] = {0, 0};
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

// --- pass flags ------------------------------------------------------------

// out[c] = some row has code c (c < n_codes); out[n_codes + j] = some row
// has feature bit j (j < n_bits); out[n_codes + n_bits] = the pass loop
// goes on: some row's code is not `null_code` or some row has a bit of
// `cont_mask`, and no row has a bit of `stop_mask`. Sets handle `h` (when
// not 0) to that last value.
__global__ void __launch_bounds__(THREADS)
pass_flags_k(const int32_t *code, const int32_t *feat, int H, int n_codes,
             int n_bits, int null_code, int cont_mask, int stop_mask,
             int32_t *out, cudaGraphConditionalHandle h) {
    __shared__ int pres[MAX_CODES];
    __shared__ int bits, live;
    for (int i = threadIdx.x; i < n_codes; i += THREADS) pres[i] = 0;
    if (threadIdx.x == 0) bits = live = 0;
    __syncthreads();
    int b = 0, nn = 0;
    for (int r = threadIdx.x; r < H; r += THREADS) {
        int c = code[r];
        if (c >= 0 && c < n_codes) pres[c] = 1;
        nn |= c != null_code;
        if (feat) b |= feat[r];
    }
    b = __reduce_or_sync(0xffffffffu, b);
    nn = __reduce_or_sync(0xffffffffu, nn);
    if ((threadIdx.x & 31) == 0) {
        atomicOr(&bits, b);
        atomicOr(&live, nn);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_codes; i += THREADS) out[i] = pres[i];
    for (int j = threadIdx.x; j < n_bits; j += THREADS)
        out[n_codes + j] = (bits >> j) & 1;
    if (threadIdx.x == 0) {
        exec_count[0] += 1;
        int cont = (live || (bits & cont_mask)) && !(bits & stop_mask);
        out[n_codes + n_bits] = cont;
        if (h) cudaGraphSetConditional(h, cont);
    }
}

extern "C" int sf_pass_flags(void *stream, const void *code, const void *feat,
                             int H, int n_codes, int n_bits, int null_code,
                             int cont_mask, int stop_mask, void *out,
                             unsigned long long h) {
    if (n_codes > MAX_CODES || n_bits > 31) return cudaErrorInvalidValue;
    pass_flags_k<<<1, THREADS, 0, S(stream)>>>(
        (const int32_t *)code, (const int32_t *)feat, H, n_codes, n_bits,
        null_code, cont_mask, stop_mask, (int32_t *)out,
        (cudaGraphConditionalHandle)h);
    return cudaGetLastError();
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
// stop time, and whether the queues hold an event below that end
__device__ static void open_window(long long *W, long long minq,
                                   cudaGraphConditionalHandle h) {
    long long ws = W[W_WS];
    int cont = W[W_I] < W[W_MAXW] && ws < W[W_STOP] && ws < SIMTIME_MAX;
    long long weff = W[W_WE] < W[W_STOP] ? W[W_WE] : W[W_STOP];
    W[W_CONT] = cont;
    W[W_WEFF] = weff;
    W[W_RAN] = minq < weff;
    if (h) cudaGraphSetConditional(h, cont);
}

__global__ void __launch_bounds__(THREADS)
advance_k(const long long *eq_next, const long long *ob_next,
          const int32_t *ob_cnt, int H, long long *W, int mode,
          cudaGraphConditionalHandle h) {
    __shared__ long long smq[THREADS / 32], smo[THREADS / 32],
        sso[THREADS / 32];
    long long mq = SIMTIME_MAX, mo = SIMTIME_MAX, so = 0;
    for (int r = threadIdx.x; r < H; r += THREADS) {
        long long a = eq_next[r], b = ob_next[r];
        mq = a < mq ? a : mq;
        mo = b < mo ? b : mo;
        so += ob_cnt[r];
    }
    mq = warp_min(mq);
    mo = warp_min(mo);
    so = warp_sum(so);
    int w = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        smq[w] = mq;
        smo[w] = mo;
        sso[w] = so;
    }
    __syncthreads();
    if (threadIdx.x) return;
    exec_count[1] += 1;
    for (int i = 1; i < THREADS / 32; i++) {
        mq = smq[i] < mq ? smq[i] : mq;
        mo = smo[i] < mo ? smo[i] : mo;
        so += sso[i];
    }
    if (mode == ADV_SHIP) {
        W[W_OB0] = so;
        W[W_EX] = so > 0;
        return;
    }
    if (mode == ADV_STEP) {
        // anti-livelock: a window that executed nothing and shipped
        // nothing re-opens at the earliest queue event, not at the same
        // carried arrival
        int progressed = W[W_RAN] || so < W[W_OB0];
        long long nt = progressed ? (mo < mq ? mo : mq) : mq;
        W[W_WS] = nt;
        W[W_WE] = nt == SIMTIME_MAX ? SIMTIME_MAX : nt + W[W_JUMP];
        W[W_I] += 1;
    }
    open_window(W, mq, h);
}

extern "C" int sf_advance(void *stream, const void *eq_next,
                          const void *ob_next, const void *ob_cnt, int H,
                          void *W, int mode, unsigned long long h) {
    advance_k<<<1, THREADS, 0, S(stream)>>>(
        (const long long *)eq_next, (const long long *)ob_next,
        (const int32_t *)ob_cnt, H, (long long *)W, mode,
        (cudaGraphConditionalHandle)h);
    return cudaGetLastError();
}
