// Multithreaded edge-list text parser.
//
// Reference analog: crates/builder/src/input/edgelist.rs:15-278 — mmap +
// one parser thread per chunk, chunks aligned to line boundaries,
// byte-level ASCII digit parsing, CRLF tolerated.  This is the native
// fast path behind graph_tpu_torch.io.edgelist (the pandas reader is the
// portable fallback).  graph_tpu_torch's own copy of graph_tpu's parser;
// the parse is the same, and gt_edge_list_threads tells the caller how
// many threads it splits a file over.
//
// C ABI:
//   int  gt_parse_edge_list(path, weighted, &result)   -> 0 on success
//   void gt_free_edge_list(&result)
//   int  gt_edge_list_threads(size)   -> parser threads for a file of size bytes

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {

struct GtEdgeList {
  int64_t *src;
  int64_t *dst;
  float *val;
  int64_t count;
};

} // extern "C"

namespace {

struct Chunk {
  const char *begin;
  const char *end;
  std::vector<int64_t> src;
  std::vector<int64_t> dst;
  std::vector<float> val;
};

inline bool is_digit(char c) { return c >= '0' && c <= '9'; }

void parse_chunk(Chunk *chunk, bool weighted) {
  const char *p = chunk->begin;
  const char *end = chunk->end;
  while (p < end) {
    // skip separators / blank lines
    while (p < end && !is_digit(*p)) {
      ++p;
    }
    if (p >= end) break;
    int64_t s = 0;
    while (p < end && is_digit(*p)) {
      s = s * 10 + (*p - '0');
      ++p;
    }
    while (p < end && !is_digit(*p)) ++p;
    if (p >= end) break;
    int64_t t = 0;
    while (p < end && is_digit(*p)) {
      t = t * 10 + (*p - '0');
      ++p;
    }
    if (weighted) {
      while (p < end && !is_digit(*p) && *p != '-' && *p != '+' && *p != '.') ++p;
      char *next = nullptr;
      float w = strtof(p, &next);
      p = next ? next : p;
      chunk->val.push_back(w);
    }
    chunk->src.push_back(s);
    chunk->dst.push_back(t);
    // skip to end of line
    while (p < end && *p != '\n') ++p;
  }
}

} // namespace

extern "C" {

int gt_edge_list_threads(int64_t size) {
  // tiny files: single chunk
  if (size < (1 << 20)) return 1;
  const unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

int gt_parse_edge_list(const char *path, int weighted, GtEdgeList *out) {
  out->src = nullptr;
  out->dst = nullptr;
  out->val = nullptr;
  out->count = 0;

  int fd = open(path, O_RDONLY);
  if (fd < 0) return 1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return 1;
  }
  size_t size = static_cast<size_t>(st.st_size);
  if (size == 0) {
    close(fd);
    return 0;
  }
  void *map = mmap(nullptr, size, PROT_READ, MAP_PRIVATE | MAP_POPULATE, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return 1;
  const char *data = static_cast<const char *>(map);

  const unsigned n_threads =
      static_cast<unsigned>(gt_edge_list_threads(static_cast<int64_t>(size)));

  // chunk boundaries aligned to the next '\n' (edgelist.rs:205-250)
  std::vector<Chunk> chunks(n_threads);
  size_t per = size / n_threads;
  size_t begin = 0;
  for (unsigned i = 0; i < n_threads; ++i) {
    size_t end = (i + 1 == n_threads) ? size : (i + 1) * per;
    if (end < size) {
      while (end < size && data[end] != '\n') ++end;
      if (end < size) ++end; // include the newline
    }
    if (end > size) end = size;
    if (begin > end) begin = end;
    chunks[i].begin = data + begin;
    chunks[i].end = data + end;
    begin = end;
  }

  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (auto &c : chunks) {
    threads.emplace_back(parse_chunk, &c, weighted != 0);
  }
  for (auto &t : threads) t.join();

  int64_t total = 0;
  for (auto &c : chunks) total += static_cast<int64_t>(c.src.size());

  out->src = static_cast<int64_t *>(malloc(sizeof(int64_t) * total));
  out->dst = static_cast<int64_t *>(malloc(sizeof(int64_t) * total));
  if (weighted) out->val = static_cast<float *>(malloc(sizeof(float) * total));
  if (!out->src || !out->dst || (weighted && !out->val)) {
    munmap(map, size);
    free(out->src);
    free(out->dst);
    free(out->val);
    return 2;
  }

  int64_t offset = 0;
  for (auto &c : chunks) {
    const int64_t k = static_cast<int64_t>(c.src.size());
    memcpy(out->src + offset, c.src.data(), sizeof(int64_t) * k);
    memcpy(out->dst + offset, c.dst.data(), sizeof(int64_t) * k);
    if (weighted) memcpy(out->val + offset, c.val.data(), sizeof(float) * k);
    offset += k;
  }
  out->count = total;
  munmap(map, size);
  return 0;
}

void gt_free_edge_list(GtEdgeList *out) {
  free(out->src);
  free(out->dst);
  free(out->val);
  out->src = nullptr;
  out->dst = nullptr;
  out->val = nullptr;
  out->count = 0;
}

} // extern "C"
