// Native RecordIO reader + threaded batch pipeline.
//
// The PyTorch port's copy of the JAX package's reader (the port imports
// nothing of that package): the counterpart of the reference's C++ IO stack:
//   - dmlc recordio parsing        (3rdparty/dmlc-core recordio format)
//   - the batch-assembly half of ImageRecordIter's pipeline
//     (src/io/iter_image_recordio_2.cc:708-940) and the prefetcher
//     double-buffer (src/io/iter_prefetcher.h)
//
// Design: the .rec file is mmap'd; an index of (offset, length) per record
// is built once at open. A worker pool copies/assembles requested records
// into caller-provided contiguous batch buffers in parallel — the
// host-side work that Python's GIL would serialize. JPEG decode+augment
// lives in imagerec.cc (same core, links libjpeg). Zero dependencies here
// beyond the C++17 standard library.
//
// Exposed C ABI (ctypes): see incubator_mxnet_tpu_torch/native/__init__.py.

#include "recordio_core.h"

using mxtpu_io::CopyRecord;
using mxtpu_io::Reader;
using mxtpu_io::Record;

extern "C" {

void* rr_open(const char* path, int num_threads) {
  return mxtpu_io::OpenReader(path, num_threads);
}

void rr_close(void* handle) {
  mxtpu_io::CloseReader(static_cast<Reader*>(handle));
}

int64_t rr_count(void* handle) {
  return static_cast<Reader*>(handle)->records.size();
}

int64_t rr_record_len(void* handle, int64_t idx) {
  auto* r = static_cast<Reader*>(handle);
  if (idx < 0 || idx >= static_cast<int64_t>(r->records.size())) return -1;
  return r->records[idx].length;
}

// Copy one record's payload into out; returns bytes written or -1.
int64_t rr_read(void* handle, int64_t idx, uint8_t* out, int64_t out_len) {
  auto* r = static_cast<Reader*>(handle);
  if (idx < 0 || idx >= static_cast<int64_t>(r->records.size())) return -1;
  const Record& rec = r->records[idx];
  if (out_len < static_cast<int64_t>(rec.length)) return -1;
  return CopyRecord(r, rec, out);
}

// Parallel batch gather: for each of n records (indices[i]), copy its
// payload (with fixed stride) into out + i*stride, in parallel on the pool.
// Records longer than stride are truncated; shorter ones zero-padded.
// Returns 0 on success.
int rr_read_batch(void* handle, const int64_t* indices, int64_t n,
                  uint8_t* out, int64_t stride) {
  auto* r = static_cast<Reader*>(handle);
  std::atomic<int64_t> done{0};
  std::atomic<int> bad{0};
  std::mutex mu;
  std::condition_variable cv;
  for (int64_t i = 0; i < n; ++i) {
    r->pool->Submit([r, i, n, indices, out, stride, &done, &bad, &mu, &cv] {
      int64_t idx = indices[i];
      uint8_t* dst = out + i * stride;
      if (idx < 0 || idx >= static_cast<int64_t>(r->records.size())) {
        bad.store(1);
      } else {
        const Record& rec = r->records[idx];
        if (static_cast<int64_t>(rec.length) >= stride) {
          // copy a truncated view (no reassembly buffer needed if unchunked)
          if (!rec.chunked) {
            std::memcpy(dst, r->data + rec.offset + 8, stride);
          } else {
            std::vector<uint8_t> tmp(rec.length);
            CopyRecord(r, rec, tmp.data());
            std::memcpy(dst, tmp.data(), stride);
          }
        } else {
          uint64_t w;
          if (!rec.chunked) {
            std::memcpy(dst, r->data + rec.offset + 8, rec.length);
            w = rec.length;
          } else {
            std::vector<uint8_t> tmp(rec.length);
            w = CopyRecord(r, rec, tmp.data());
            std::memcpy(dst, tmp.data(), w);
          }
          std::memset(dst + w, 0, stride - w);
        }
      }
      if (done.fetch_add(1) + 1 == static_cast<int64_t>(n)) {
        std::unique_lock<std::mutex> lk(mu);
        cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done.load() == n; });
  return bad.load() ? -1 : 0;
}

const char* rr_version() { return "incubator-mxnet-tpu-native-recordio/1"; }

}  // extern "C"
