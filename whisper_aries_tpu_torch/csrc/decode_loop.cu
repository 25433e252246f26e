// The on-device decode loop (ops/decode_loop.py): a decode call's steps as
// one CUDA graph that loops on the card until the loop's condition is
// false, with no host read per token; and the sampled rungs' uniform draws.
//
// Replaces: whisper_aries_tpu/decoding/generate.py, the greedy and beam
// `lax.while_loop`s (:423 greedy, :948 beam; their `cond`s at :400 and
// :898), and the draw of `jax.random.categorical` (:364), which the TPU
// makes inside its loop from its own random bits.
//
// The loop graph (outer graph, built here from a step that PyTorch
// captured):
//
//   [cond kernel]  ->  [WHILE node, handle h]
//                        body: [child graph: the captured step, ending in
//                               the cond kernel, which sets h]
//
// A WHILE node runs its body while h is non-zero, checked before each
// iteration, so the cond kernel before it makes a call whose rows all
// finished on the first token run no step, as the JAX loop does. The
// body is the step PyTorch captured (embedding, decoder layers, vocab
// product, filters or beam tail, bookkeeping), added as a child graph
// node: its nodes, and the memory PyTorch's graph pool gave them, are the
// captured graph's, which the Python side keeps alive with the loop.
//
// The cond kernel is one warp: the JAX `cond` on the device state,
// greedy `!all(finished) && pos < L`, beam `!all(fin_count >= C) && pos
// < L`; it writes the answer to `cont` (the host loop's flag) and, inside
// the graph, into the handle. Bound: a launch (it reads R bytes).
//
// The draw kernel: u[r, v] in (0, 1), a counter-based hash of (seed, row,
// pos, v) (draw.cuh), so a graph that replays it at every step draws new
// numbers at each position and the same numbers for the same seed. It gives
// the plain version's bits (integer hash, exact conversions: 23 bits +
// 0.5). The decode loop no longer launches it: decode_choice.cu draws the
// same bits in registers inside the greedy choice. It stays as the hold of
// the hash against the plain version. Bound: bytes, R x V x 4 written.
#include "common.cuh"
#include "draw.cuh"

namespace {

__global__ void __launch_bounds__(32)
loop_cond_kernel(const unsigned char* __restrict__ finished,
                 const long long* __restrict__ counts, int n,
                 long long need, const int* __restrict__ pos, int L,
                 cudaGraphConditionalHandle handle, int set,
                 int* __restrict__ cont) {
  bool done = true;
  for (int i = threadIdx.x; i < n; i += 32)
    done = done && (finished ? finished[i] != 0 : counts[i] >= need);
  done = __all_sync(0xffffffffu, done);
  if (threadIdx.x == 0) {
    const int go = (!done && *pos < L) ? 1 : 0;
    *cont = go;
    if (set) cudaGraphSetConditional(handle, go);
  }
}

constexpr int DRAW_THREADS = 256;

__global__ void __launch_bounds__(DRAW_THREADS)
uniform_draw_kernel(uint32_t seed_lo, uint32_t seed_hi,
                    const int* __restrict__ pos, int V,
                    float* __restrict__ u) {
  const int r = blockIdx.y;
  const uint32_t key = draw_key(seed_lo, seed_hi, r, *pos);
  const int v = blockIdx.x * DRAW_THREADS + threadIdx.x;
  if (v >= V) return;
  u[(long long)r * V + v] = draw_uniform(key, v);
}

struct Loop {
  cudaGraph_t outer = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaGraphConditionalHandle handle = 0;
};

}  // namespace

extern "C" {

// The cond kernel on `stream`: `finished` (n bools) or `counts` (n int64,
// done at >= need), `pos` an int32 on the device; `set` 1 inside a loop
// graph's body (writes `handle`), 0 outside any graph.
int aries_loop_cond(const void* finished, const void* counts, int n,
                    long long need, const void* pos, int L,
                    unsigned long long handle, int set, void* cont,
                    void* stream) {
  if (n < 0 || (n > 0 && !finished && !counts) || !pos || !cont)
    return (int)cudaErrorInvalidValue;
  loop_cond_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      static_cast<const unsigned char*>(finished),
      static_cast<const long long*>(counts), n, need,
      static_cast<const int*>(pos), L, handle, set, static_cast<int*>(cont));
  return launch_status();
}

// u (R, V) f32 <- the draws of rows 0..R-1 at the device position `pos`.
int aries_uniform_draw(unsigned seed_lo, unsigned seed_hi, const void* pos,
                       int R, int V, void* u, void* stream) {
  if (R <= 0 || V <= 0 || R > 65535 || !pos || !u)
    return (int)cudaErrorInvalidValue;
  dim3 grid((V + DRAW_THREADS - 1) / DRAW_THREADS, R);
  uniform_draw_kernel<<<grid, DRAW_THREADS, 0, (cudaStream_t)stream>>>(
      seed_lo, seed_hi, static_cast<const int*>(pos), V,
      static_cast<float*>(u));
  return launch_status();
}

// A new loop: its outer graph and the WHILE node's handle (made before the
// body is captured, since the body's cond kernel takes the handle).
int aries_loop_create(void** out, unsigned long long* handle) {
  Loop* lp = new Loop();
  cudaError_t err = cudaGraphCreate(&lp->outer, 0);
  if (err == cudaSuccess)
    err = cudaGraphConditionalHandleCreate(&lp->handle, lp->outer, 0, 0);
  if (err != cudaSuccess) {
    if (lp->outer) cudaGraphDestroy(lp->outer);
    delete lp;
    return (int)err;
  }
  *out = lp;
  *handle = lp->handle;
  return 0;
}

// Build and instantiate the loop: the cond kernel on the state as it is
// before the loop, then the WHILE node whose body is `body` (a
// cudaGraph_t, cloned as a child graph). `stage` names the call that
// failed: 1 the cond kernel's node, 2 the WHILE node, 3 the child graph,
// 4 the instantiation.
int aries_loop_build(void* loop, void* body, const void* finished,
                     const void* counts, int n, long long need,
                     const void* pos, int L, void* cont, int* stage) {
  Loop* lp = static_cast<Loop*>(loop);
  if (!lp || !body || !pos || !cont || (n > 0 && !finished && !counts))
    return (int)cudaErrorInvalidValue;
  const unsigned char* fin = static_cast<const unsigned char*>(finished);
  const long long* cnt = static_cast<const long long*>(counts);
  const int* p = static_cast<const int*>(pos);
  int* c = static_cast<int*>(cont);
  int set = 1;
  void* args[] = {&fin, &cnt, &n, &need, &p, &L, &lp->handle, &set, &c};
  cudaKernelNodeParams kp = {};
  kp.func = (void*)loop_cond_kernel;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(32);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  kp.extra = nullptr;
  cudaGraphNode_t pre, node, child;
  *stage = 1;
  cudaError_t err = cudaGraphAddKernelNode(&pre, lp->outer, nullptr, 0, &kp);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = lp->handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  *stage = 2;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, lp->outer, &pre, nullptr, 1, &cp);
#else
  err = cudaGraphAddNode(&node, lp->outer, &pre, 1, &cp);
#endif
  if (err != cudaSuccess) return (int)err;
  *stage = 3;
  err = cudaGraphAddChildGraphNode(&child, cp.conditional.phGraph_out[0],
                                   nullptr, 0, static_cast<cudaGraph_t>(body));
  if (err != cudaSuccess) return (int)err;
  *stage = 4;
  err = cudaGraphInstantiate(&lp->exec, lp->outer, 0);
  if (err != cudaSuccess) return (int)err;
  *stage = 0;
  return 0;
}

int aries_loop_launch(void* loop, void* stream) {
  Loop* lp = static_cast<Loop*>(loop);
  if (!lp || !lp->exec) return (int)cudaErrorInvalidValue;
  return (int)cudaGraphLaunch(lp->exec, (cudaStream_t)stream);
}

int aries_loop_destroy(void* loop) {
  Loop* lp = static_cast<Loop*>(loop);
  if (!lp) return 0;
  cudaError_t err = cudaSuccess;
  if (lp->exec) err = cudaGraphExecDestroy(lp->exec);
  if (lp->outer) {
    cudaError_t e2 = cudaGraphDestroy(lp->outer);
    if (err == cudaSuccess) err = e2;
  }
  delete lp;
  return (int)err;
}

// The number of nodes of graph `g` (the captured body), for the records.
int aries_graph_nodes(void* g, unsigned long long* n) {
  size_t k = 0;
  const cudaError_t err =
      cudaGraphGetNodes(static_cast<cudaGraph_t>(g), nullptr, &k);
  *n = k;
  return (int)err;
}

// The runtime's version, for the loop's error messages.
int aries_loop_runtime_version() {
  int v = 0;
  cudaRuntimeGetVersion(&v);
  return v;
}

}  // extern "C"
