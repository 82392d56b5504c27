// Shared core of the native IO stack: mmap'd recordio index + thread pool
// (the PyTorch port's copy of the JAX package's header).
// Used by recordio.cc (byte mover) and imagerec.cc (JPEG decode+augment).
//
// Reference equivalents: 3rdparty/dmlc-core recordio framing and the worker
// pool under src/io/iter_image_recordio_2.cc. Header-only so each .so stays
// a single-TU build with no link-time coupling.
#ifndef MXTPU_NATIVE_RECORDIO_CORE_H_
#define MXTPU_NATIVE_RECORDIO_CORE_H_

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace mxtpu_io {

constexpr uint32_t kMagic = 0x3ed7230a;
constexpr uint32_t kLFlagBits = 29;
constexpr uint32_t kLMask = (1u << kLFlagBits) - 1;

struct Record {
  uint64_t offset;  // start of first chunk header
  uint64_t length;  // total payload length after reassembly
  bool chunked;
};

class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] { Loop(); });
    }
  }
  ~ThreadPool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  void Submit(std::function<void()> fn) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      q_.push(std::move(fn));
    }
    cv_.notify_one();
  }
  int size() const { return static_cast<int>(workers_.size()); }

 private:
  void Loop() {
    for (;;) {
      std::function<void()> fn;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !q_.empty(); });
        if (stop_ && q_.empty()) return;
        fn = std::move(q_.front());
        q_.pop();
      }
      fn();
    }
  }
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> q_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

struct Reader {
  int fd = -1;
  const uint8_t* data = nullptr;
  uint64_t size = 0;
  std::vector<Record> records;
  ThreadPool* pool = nullptr;
  std::string error;
};

inline uint32_t ReadU32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

// Scan the mapped file, building the record index. Returns false on a
// malformed stream.
inline bool BuildIndex(Reader* r) {
  uint64_t pos = 0;
  while (pos + 8 <= r->size) {
    if (ReadU32(r->data + pos) != kMagic) {
      r->error = "bad magic at offset " + std::to_string(pos);
      return false;
    }
    uint64_t start = pos;
    uint64_t total = 0;
    bool chunked = false;
    for (;;) {
      if (pos + 8 > r->size) {
        r->error = "truncated record header";
        return false;
      }
      if (ReadU32(r->data + pos) != kMagic) {
        r->error = "bad chunk magic";
        return false;
      }
      uint32_t lrec = ReadU32(r->data + pos + 4);
      uint32_t cflag = lrec >> kLFlagBits;
      uint64_t len = lrec & kLMask;
      pos += 8 + ((len + 3u) & ~3ull);  // header + padded payload
      if (pos > r->size) {
        r->error = "truncated record payload";
        return false;
      }
      total += len;
      if (cflag == 0) {
        break;
      }
      chunked = true;
      total += 4;  // the split-out magic bytes rejoin the payload
      if (cflag == 3) {
        total -= 4;  // final chunk: magic already counted with cflag 1/2
        break;
      }
    }
    r->records.push_back({start, total, chunked});
  }
  return true;
}

// Reassemble record payload into out (caller sized via record length).
inline uint64_t CopyRecord(const Reader* r, const Record& rec, uint8_t* out) {
  uint64_t pos = rec.offset;
  uint64_t written = 0;
  bool first = true;
  for (;;) {
    uint32_t lrec = ReadU32(r->data + pos + 4);
    uint32_t cflag = lrec >> kLFlagBits;
    uint64_t len = lrec & kLMask;
    if (!first) {
      // continuation chunks re-insert the magic separator
      std::memcpy(out + written, &kMagic, 4);
      written += 4;
    }
    std::memcpy(out + written, r->data + pos + 8, len);
    written += len;
    pos += 8 + ((len + 3u) & ~3ull);
    if (cflag == 0 || cflag == 3) break;
    first = false;
  }
  return written;
}

inline Reader* OpenReader(const char* path, int num_threads) {
  auto* r = new Reader();
  r->fd = ::open(path, O_RDONLY);
  if (r->fd < 0) {
    delete r;
    return nullptr;
  }
  struct stat st;
  if (fstat(r->fd, &st) != 0) {
    ::close(r->fd);
    delete r;
    return nullptr;
  }
  r->size = static_cast<uint64_t>(st.st_size);
  r->data = static_cast<const uint8_t*>(
      mmap(nullptr, r->size, PROT_READ, MAP_PRIVATE, r->fd, 0));
  if (r->data == MAP_FAILED) {
    ::close(r->fd);
    delete r;
    return nullptr;
  }
  madvise(const_cast<uint8_t*>(r->data), r->size, MADV_WILLNEED);
  if (!BuildIndex(r)) {
    munmap(const_cast<uint8_t*>(r->data), r->size);
    ::close(r->fd);
    delete r;
    return nullptr;
  }
  r->pool = new ThreadPool(num_threads > 0 ? num_threads : 4);
  return r;
}

inline void CloseReader(Reader* r) {
  if (!r) return;
  delete r->pool;
  munmap(const_cast<uint8_t*>(r->data), r->size);
  ::close(r->fd);
  delete r;
}

}  // namespace mxtpu_io

#endif  // MXTPU_NATIVE_RECORDIO_CORE_H_
