// resuneta_torch native data loader (the port's copy of the JAX package's
// native/loader.cpp, the same C ABI and bytes)
//
// The reference's input pipeline loads one .npy file per patch per label head,
// serially, on the training critical path (train_ISPRS.py:122-146). This loader
// replaces that with a C++ thread pool doing parallel open/parse/read straight
// into a caller-provided batch buffer — no Python-level GIL contention, one
// memcpy per file — and gathers the packed dataset's rows in parallel.
//
// Exposed as a minimal C ABI consumed via ctypes
// (resuneta_torch/data/native_loader.py), which builds it at first use into
// build/loader/libresuneta_loader-<hash>.so with
//   g++ -O3 -std=c++17 -fPIC -Wall -shared -o <so> loader.cpp -lpthread

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Parse a .npy header: returns payload offset, or -1 on failure.
// (Format: \x93NUMPY <maj> <min> <hlen u16/u32> <header dict padded to 64>.)
long npy_payload_offset(FILE* f) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return -1;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return -1;
  const int major = magic[6];
  unsigned long hlen = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return -1;
    hlen = b[0] | (b[1] << 8);
    return 10 + (long)hlen;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return -1;
    hlen = (unsigned long)b[0] | ((unsigned long)b[1] << 8) |
           ((unsigned long)b[2] << 16) | ((unsigned long)b[3] << 24);
    return 12 + (long)hlen;
  }
}

// Read the payload of one .npy file into dest; expect exactly `bytes` of data.
int load_one(const char* path, char* dest, long bytes) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  long off = npy_payload_offset(f);
  if (off < 0) {
    fclose(f);
    return 2;
  }
  if (fseek(f, off, SEEK_SET) != 0) {
    fclose(f);
    return 3;
  }
  size_t got = fread(dest, 1, (size_t)bytes, f);
  // must consume exactly `bytes` and hit EOF right after
  int extra = fgetc(f);
  fclose(f);
  if (got != (size_t)bytes || extra != EOF) return 4;
  return 0;
}

}  // namespace

extern "C" {

// Load n .npy files in parallel into dest (n * bytes_per_item bytes).
// Returns 0 on success; otherwise the first nonzero per-file error code.
int rl_load_batch(const char** paths, int n, char* dest, long bytes_per_item,
                  int n_threads) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;

  std::atomic<int> next(0);
  std::atomic<int> err(0);

  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n || err.load() != 0) break;
      int rc = load_one(paths[i], dest + (long)i * bytes_per_item, bytes_per_item);
      if (rc != 0) {
        int expected = 0;
        err.compare_exchange_strong(expected, rc);
      }
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return err.load();
}

// Gathers rows from a memory-mapped (or in-memory) source array into a dense
// batch: dest[i] = src[indices[i]]. Parallel memcpy — used by the packed
// dataset to assemble shuffled batches without Python-loop overhead.
int rl_gather_rows(const char* src, const long* indices, int n, char* dest,
                   long bytes_per_item, int n_threads) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;

  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      memcpy(dest + (long)i * bytes_per_item,
             src + indices[i] * bytes_per_item, (size_t)bytes_per_item);
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
