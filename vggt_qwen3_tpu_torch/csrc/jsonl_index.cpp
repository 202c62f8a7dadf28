// jsonl_index — mmap-backed JSONL line index with a C ABI (loaded with ctypes
// by vggt_qwen3_tpu_torch/data/jsonl_index.py).
//
// The data layer's reader of .jsonl splits: the file is mapped, its newline
// offsets are scanned once (a memchr loop), and each record is served as a
// zero-copy (ptr, len) view for O(1) random access from any thread, so a
// record is parsed in Python only when a sample is read. Lines are kept as
// the Python reader keeps them: a trailing \r is stripped and blank lines
// (spaces, tabs, \r) are skipped.
//
// Built with the host C++ compiler at first use (data/native.py).
// API (thread-safe once opened):
//   void*       jsonl_open(const char* path);            // NULL on failure
//   long        jsonl_count(void* h);
//   const char* jsonl_get(void* h, long i, long* len);   // NULL if i is out of range
//   void        jsonl_close(void* h);

#include <cstdint>
#include <cstring>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Index {
  int fd = -1;
  const char* data = nullptr;
  size_t size = 0;
  // offsets[i] = start of line i; lengths exclude the trailing newline.
  std::vector<size_t> starts;
  std::vector<size_t> lens;
};

bool is_blank(const char* p, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    char c = p[i];
    if (c != ' ' && c != '\t' && c != '\r') return false;
  }
  return true;
}

}  // namespace

extern "C" {

void* jsonl_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  madvise(mem, st.st_size, MADV_SEQUENTIAL);

  auto* idx = new Index();
  idx->fd = fd;
  idx->data = static_cast<const char*>(mem);
  idx->size = static_cast<size_t>(st.st_size);

  const char* base = idx->data;
  size_t pos = 0;
  while (pos < idx->size) {
    const char* nl = static_cast<const char*>(
        memchr(base + pos, '\n', idx->size - pos));
    size_t end = nl ? static_cast<size_t>(nl - base) : idx->size;
    size_t len = end - pos;
    // strip trailing \r, skip blank lines (matches the Python loader)
    if (len > 0 && base[pos + len - 1] == '\r') --len;
    if (len > 0 && !is_blank(base + pos, len)) {
      idx->starts.push_back(pos);
      idx->lens.push_back(len);
    }
    pos = end + 1;
  }
  madvise(mem, st.st_size, MADV_RANDOM);  // access pattern after indexing
  return idx;
}

long jsonl_count(void* h) {
  if (!h) return -1;
  return static_cast<long>(static_cast<Index*>(h)->starts.size());
}

const char* jsonl_get(void* h, long i, long* len) {
  if (!h || !len) return nullptr;
  auto* idx = static_cast<Index*>(h);
  if (i < 0 || static_cast<size_t>(i) >= idx->starts.size()) return nullptr;
  *len = static_cast<long>(idx->lens[i]);
  return idx->data + idx->starts[i];
}

void jsonl_close(void* h) {
  if (!h) return;
  auto* idx = static_cast<Index*>(h);
  if (idx->data) munmap(const_cast<char*>(idx->data), idx->size);
  if (idx->fd >= 0) ::close(idx->fd);
  delete idx;
}

}  // extern "C"
