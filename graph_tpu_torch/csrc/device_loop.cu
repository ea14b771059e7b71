// Device-resident iteration loops: a CUDA graph whose conditional WHILE
// node runs a captured loop body until a condition, evaluated on the card,
// is false.
//
// Replaces: the device-side loop of jax.lax.while_loop in graph_tpu's
// drivers (graph_tpu/algos/pagerank.py:130 and :430, wcc.py:106 and :255,
// sssp.py:116, :122, :185, :190 and :373).  On the TPU the condition is a
// scalar computed inside the jitted program; the host reads the result
// once.  The port's drivers would otherwise read the condition back once an
// iteration (a host round trip and an idle card per round).
//
// Design.  graph_tpu_torch/engine/loop.py captures each piece of a loop
// body into a CUDA graph with torch (torch.cuda.CUDAGraph, keep_graph=True)
// and hands over its cudaGraph_t.  The functions below assemble them: a
// "sequence" is a graph under construction whose nodes run one after the
// other.  loop_seq_while appends to a sequence the loop's condition kernel
// (run once, so that a condition false on entry runs no body, as in
// lax.while_loop) and a WHILE node, and returns the node's body as a
// sequence of its own; loop_seq_child appends a captured piece (a child
// graph node, cloned), or loop_seq_while a nested loop; loop_seq_close
// ends a body with the condition kernel again, which counts the body and
// sets the node's handle for the next round.
//
// A loop whose state alternates between two sets of buffers (the body
// captured twice: reading the first set and writing the second, then the
// reverse, so that no body copies its result back) runs two bodies a round:
// loop_seq_if appends, after the first, the condition on the second set's
// value, which counts the first body, keeps its verdict in `go` and sets an
// IF node's handle; the IF node's body holds the second body and the
// condition on the first set's value, which stores its verdict in `go`;
// the round ends by setting the WHILE node's handle from `go`.  So the
// loop can stop after either body, and the bodies the counter counts are
// the loop's iterations.
//
// Two condition kernels, one thread each:
//
//   loop_cond_flag      continue while an int32 flag is nonzero (WCC's and
//                       SSSP's "changed", delta-stepping's buckets);
//   loop_cond_residual  continue while it < max_iterations and
//                       err >= tolerance (PageRank's cond); both limits
//                       live in device memory, so one instantiated graph
//                       serves every config.
//
// Each adds `step` (0 on entry, 1 after a body) to the loop's counter in
// device memory, which the host zeroes before a launch and reads after
// it.  Bound: one thread's few loads and a store a round, under a
// microsecond; the bodies' kernels set the time.
//
// loop_graph_kernels lists the kernel nodes of a captured graph by their
// device functions' names, so that the host can hold the kernels a body's
// wrappers counted at capture against the kernels the graph will run.
//
// Every entry point returns the CUDA error code (0 on success).

#include <cuda.h>  // driver types only: the driver is reached by entry point
#include <cuda_runtime.h>

#include <cstring>
#include <new>
#include <vector>

namespace {

constexpr int kFlag = 0;
constexpr int kResidual = 1;

// What loop_seq_close appends to a body.
enum Close {
  kSet = 0,     // the condition, setting the WHILE node's handle
  kStore = 1,   // the condition, storing its verdict in go (an IF body)
  kFromGo = 2,  // the WHILE node's handle set from go
};

__global__ void loop_cond_flag(cudaGraphConditionalHandle handle, int set,
                               int* go, int* it, const int* flag, int step) {
  *it += step;
  const unsigned int c = *flag != 0 ? 1u : 0u;
  if (go != nullptr) *go = static_cast<int>(c);
  if (set) cudaGraphSetConditional(handle, c);
}

__global__ void loop_cond_residual(cudaGraphConditionalHandle handle, int set,
                                   int* go, int* it, const float* err,
                                   const int* max_iterations,
                                   const float* tolerance, int step) {
  const int i = *it + step;
  *it = i;
  const unsigned int c = (i < *max_iterations && *err >= *tolerance) ? 1u : 0u;
  if (go != nullptr) *go = static_cast<int>(c);
  if (set) cudaGraphSetConditional(handle, c);
}

__global__ void loop_cond_go(cudaGraphConditionalHandle handle,
                             const int* go) {
  cudaGraphSetConditional(handle, *go != 0 ? 1u : 0u);
}

// A loop's condition: its kind, counter, scalar and limits.
struct Cond {
  int kind;
  int* it;
  const void* value;
  const int* max_iterations;
  const float* tolerance;
};

// A graph under construction; each appended node follows the last one.
struct Seq {
  cudaGraph_t graph;
  cudaGraphNode_t last;  // null while the graph is empty
  bool owned;            // the top level: destroyed with the sequence
  // a conditional body's condition, appended by loop_seq_close
  cudaGraphConditionalHandle handle;
  Cond cond;
  int close;
  int* go;
};

cudaError_t append_kernel(Seq* s, cudaKernelNodeParams* p) {
  cudaGraphNode_t node;
  cudaError_t err = cudaGraphAddKernelNode(
      &node, s->graph, s->last ? &s->last : nullptr, s->last ? 1 : 0, p);
  if (err == cudaSuccess) s->last = node;
  return err;
}

cudaKernelNodeParams one_thread() {
  cudaKernelNodeParams p = {};
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.extra = nullptr;
  return p;
}

// Append c's condition kernel on `value`: it adds `step` to the counter,
// stores its verdict in `go` (if not null) and sets `handle` if `set`.
cudaError_t append_cond(Seq* s, cudaGraphConditionalHandle handle, int set,
                        int* go, Cond c, const void* value, int step) {
  cudaKernelNodeParams p = one_thread();
  const int* flag = static_cast<const int*>(value);
  const float* err = static_cast<const float*>(value);
  void* flag_args[] = {&handle, &set, &go, &c.it, &flag, &step};
  void* residual_args[] = {&handle, &set, &go, &c.it, &err,
                           &c.max_iterations, &c.tolerance, &step};
  if (c.kind == kFlag) {
    p.func = reinterpret_cast<void*>(loop_cond_flag);
    p.kernelParams = flag_args;
  } else if (c.kind == kResidual) {
    p.func = reinterpret_cast<void*>(loop_cond_residual);
    p.kernelParams = residual_args;
  } else {
    return cudaErrorInvalidValue;
  }
  return append_kernel(s, &p);
}

// Append a conditional node of `type` on a new handle of s's graph;
// *body_out is its body as a sequence (not owned).
cudaError_t append_conditional(Seq* s, cudaGraphConditionalNodeType type,
                               cudaGraphConditionalHandle handle,
                               Seq** body_out) {
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = type;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  cudaError_t err = cudaGraphAddNode(&node, s->graph, &s->last, 1, &params);
  if (err != cudaSuccess) return err;
  s->last = node;
  Seq* body = new (std::nothrow) Seq{};
  if (body == nullptr) return cudaErrorMemoryAllocation;
  body->graph = params.conditional.phGraph_out[0];
  body->owned = false;
  *body_out = body;
  return cudaSuccess;
}

// The driver functions loop_graph_kernels calls, fetched through the
// runtime (no link against libcuda).
struct Driver {
  CUresult (*node_params)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS_v2*);
  CUresult (*kernel_function)(CUfunction*, CUkernel);
  CUresult (*function_name)(const char**, CUfunction);
};

template <typename F>
cudaError_t entry_point(const char* symbol, F* out) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      symbol, &fn, CUDA_VERSION, cudaEnableDefault, &found);
  if (err != cudaSuccess) return err;
  if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
    return cudaErrorSymbolNotFound;
  }
  *out = reinterpret_cast<F>(fn);
  return cudaSuccess;
}

// Names go to buf, one a line; `used` counts the bytes written.
struct Names {
  char* buf;
  long long cap;
  long long used;
};

cudaError_t put(Names* out, const char* name) {
  const long long k = static_cast<long long>(std::strlen(name));
  if (out->used + k + 1 > out->cap) return cudaErrorInvalidValue;
  std::memcpy(out->buf + out->used, name, static_cast<size_t>(k));
  out->used += k;
  out->buf[out->used++] = '\n';
  return cudaSuccess;
}

// Every kernel node of g and of its child graphs, depth first.
cudaError_t walk(const Driver& d, cudaGraph_t g, Names* out) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes(g, nodes.data(), &n);
  if (err != cudaSuccess) return err;
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(node, &type);
    if (err != cudaSuccess) return err;
    if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      err = cudaGraphChildGraphNodeGetGraph(node, &child);
      if (err == cudaSuccess) err = walk(d, child, out);
      if (err != cudaSuccess) return err;
    } else if (type == cudaGraphNodeTypeKernel) {
      CUDA_KERNEL_NODE_PARAMS_v2 p = {};
      CUresult r = d.node_params(node, &p);
      CUfunction fn = p.func;
      if (r == CUDA_SUCCESS && fn == nullptr && p.kern != nullptr) {
        r = d.kernel_function(&fn, p.kern);
      }
      const char* name = nullptr;
      if (r == CUDA_SUCCESS) r = d.function_name(&name, fn);
      if (r != CUDA_SUCCESS) return static_cast<cudaError_t>(r);
      err = put(out, name != nullptr ? name : "?");
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// A new, empty top-level sequence.
int loop_seq_new(void** out) {
  Seq* s = new (std::nothrow) Seq{};
  if (s == nullptr) return cudaErrorMemoryAllocation;
  cudaError_t err = cudaGraphCreate(&s->graph, 0);
  if (err != cudaSuccess) {
    delete s;
    return err;
  }
  s->owned = true;
  *out = s;
  return cudaSuccess;
}

// Append a clone of `child` (a captured cudaGraph_t) as a child graph node.
int loop_seq_child(void* seq, void* child) {
  Seq* s = static_cast<Seq*>(seq);
  cudaGraphNode_t node;
  cudaError_t err = cudaGraphAddChildGraphNode(
      &node, s->graph, s->last ? &s->last : nullptr, s->last ? 1 : 0,
      static_cast<cudaGraph_t>(child));
  if (err == cudaSuccess) s->last = node;
  return err;
}

// Append the condition kernel and a WHILE node; *body_out is the node's
// body as a sequence (close it with loop_seq_close, free it with
// loop_seq_free).  kind 0: flag (max_iterations, tolerance unused);
// kind 1: residual.
int loop_seq_while(void* seq, int kind, void* it, const void* value,
                   const void* max_iterations, const void* tolerance,
                   void** body_out) {
  Seq* s = static_cast<Seq*>(seq);
  const Cond c = {kind, static_cast<int*>(it), value,
                  static_cast<const int*>(max_iterations),
                  static_cast<const float*>(tolerance)};
  cudaGraphConditionalHandle handle;
  cudaError_t err = cudaGraphConditionalHandleCreate(&handle, s->graph, 0, 0);
  if (err != cudaSuccess) return err;
  err = append_cond(s, handle, 1, nullptr, c, value, 0);
  if (err != cudaSuccess) return err;
  Seq* body = nullptr;
  err = append_conditional(s, cudaGraphCondTypeWhile, handle, &body);
  if (err != cudaSuccess) return err;
  body->handle = handle;
  body->cond = c;
  body->close = kSet;
  *body_out = body;
  return cudaSuccess;
}

// In a WHILE body, after its first body: append the condition on `value`
// (the second set's scalar), which counts that body, stores its verdict in
// *go and sets a new IF node's handle, then the IF node.  *body_out is the
// IF node's body (close it with loop_seq_close: the condition on the WHILE
// loop's own scalar, stored in *go); the WHILE body's close then sets its
// handle from *go.  Once per WHILE body.
int loop_seq_if(void* seq, const void* value, void* go, void** body_out) {
  Seq* s = static_cast<Seq*>(seq);
  if (s->owned || s->close != kSet || s->last == nullptr) {
    return cudaErrorInvalidValue;
  }
  int* flag = static_cast<int*>(go);
  cudaGraphConditionalHandle handle;
  cudaError_t err = cudaGraphConditionalHandleCreate(&handle, s->graph, 0, 0);
  if (err != cudaSuccess) return err;
  err = append_cond(s, handle, 1, flag, s->cond, value, 1);
  if (err != cudaSuccess) return err;
  Seq* body = nullptr;
  err = append_conditional(s, cudaGraphCondTypeIf, handle, &body);
  if (err != cudaSuccess) return err;
  body->cond = s->cond;
  body->close = kStore;
  body->go = flag;
  s->close = kFromGo;
  s->go = flag;
  *body_out = body;
  return cudaSuccess;
}

// End a conditional body (see Close).
int loop_seq_close(void* seq) {
  Seq* s = static_cast<Seq*>(seq);
  switch (s->close) {
    case kSet:
      return append_cond(s, s->handle, 1, nullptr, s->cond, s->cond.value, 1);
    case kStore:
      return append_cond(s, s->handle, 0, s->go, s->cond, s->cond.value, 1);
    case kFromGo: {
      cudaKernelNodeParams p = one_thread();
      cudaGraphConditionalHandle handle = s->handle;
      const int* go = s->go;
      void* args[] = {&handle, &go};
      p.func = reinterpret_cast<void*>(loop_cond_go);
      p.kernelParams = args;
      return append_kernel(s, &p);
    }
    default:
      return cudaErrorInvalidValue;
  }
}

int loop_seq_instantiate(void* seq, void** exec_out) {
  Seq* s = static_cast<Seq*>(seq);
  cudaGraphExec_t exec;
  cudaError_t err = cudaGraphInstantiate(&exec, s->graph, 0);
  if (err != cudaSuccess) return err;
  *exec_out = exec;
  return cudaSuccess;
}

int loop_exec_launch(void* exec, void* stream) {
  cudaError_t err = cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                    static_cast<cudaStream_t>(stream));
  return err == cudaSuccess ? cudaGetLastError() : err;
}

int loop_seq_free(void* seq) {
  Seq* s = static_cast<Seq*>(seq);
  cudaError_t err = s->owned ? cudaGraphDestroy(s->graph) : cudaSuccess;
  delete s;
  return err;
}

int loop_exec_free(void* exec) {
  return cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}

// The device function names of the kernel nodes of `graph` (a
// cudaGraph_t) and of its child graphs, one a line, into buf (cap bytes,
// not terminated); *used is the bytes written.
int loop_graph_kernels(void* graph, char* buf, long long cap,
                       long long* used) {
  Driver d;
  cudaError_t err = entry_point("cuGraphKernelNodeGetParams", &d.node_params);
  if (err == cudaSuccess) {
    err = entry_point("cuKernelGetFunction", &d.kernel_function);
  }
  if (err == cudaSuccess) err = entry_point("cuFuncGetName", &d.function_name);
  if (err != cudaSuccess) return err;
  Names out = {buf, cap, 0};
  err = walk(d, static_cast<cudaGraph_t>(graph), &out);
  *used = out.used;
  return err;
}

}  // extern "C"
