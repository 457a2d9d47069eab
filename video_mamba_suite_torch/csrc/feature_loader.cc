// Multi-threaded raw feature-file reader (ctypes interface).
//
// The port's copy of the JAX package's native reader: reads many binary
// files into one preallocated buffer in parallel with pread (no GIL, no
// per-file Python overhead). Built by the host's C++ compiler on first use
// and bound by ops/native.py (read_files_parallel).

#include <fcntl.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// paths: concatenated NUL-terminated strings; offsets[i] = start of path i.
// dst: preallocated buffer; dst_offsets[i] = byte offset for file i's data;
// sizes[i] = bytes to read from file i (after skipping header_skip bytes).
// Returns 0 on success, else the 1-based index of the first failed file.
std::int64_t read_files_parallel(
    const char* paths, const std::int64_t* path_offsets,
    std::int64_t num_files, char* dst, const std::int64_t* dst_offsets,
    const std::int64_t* sizes, std::int64_t header_skip,
    std::int64_t num_threads) {
  std::atomic<std::int64_t> next(0);
  std::atomic<std::int64_t> failed(0);
  auto worker = [&]() {
    while (true) {
      const std::int64_t i = next.fetch_add(1);
      if (i >= num_files || failed.load()) return;
      const char* path = paths + path_offsets[i];
      const int fd = open(path, O_RDONLY);
      if (fd < 0) { failed.store(i + 1); return; }
      std::int64_t want = sizes[i];
      std::int64_t off = header_skip;
      char* out = dst + dst_offsets[i];
      while (want > 0) {
        const ssize_t got = pread(fd, out, want, off);
        if (got <= 0) { failed.store(i + 1); break; }
        want -= got;
        off += got;
        out += got;
      }
      close(fd);
    }
  };
  std::vector<std::thread> threads;
  const std::int64_t nt = num_threads > 0 ? num_threads : 4;
  for (std::int64_t t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failed.load();
}

}  // extern "C"
