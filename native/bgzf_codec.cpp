// Native BGZF block codec with a worker thread pool.
//
// The runtime's analog of the reference's htslib bgzf layer +
// hts_tpool (src/htslib/bgzf.c, thread_pool.c): BAM emission compresses
// hundreds of MB of BGZF blocks, which is pure-CPU work that Python's
// zlib serializes on one core. This codec compresses/decompresses many
// 64 KiB blocks in parallel with std::thread workers and is loaded from
// Python via ctypes (no pybind11 dependency).
//
// Build: tools/build_native.sh  (g++ -O3 -shared -fPIC -lz -lpthread)

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

constexpr int kHeaderLen = 18;
constexpr int kFooterLen = 8;

// one BGZF block: gzip member with BC extra field holding BSIZE-1
int compress_one(const uint8_t* src, int src_len, uint8_t* dst,
                 int dst_cap, int level) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK)
    return -1;
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = src_len;
  zs.next_out = dst + kHeaderLen;
  zs.avail_out = dst_cap - kHeaderLen - kFooterLen;
  if (deflate(&zs, Z_FINISH) != Z_STREAM_END) {
    deflateEnd(&zs);
    return -1;
  }
  int cdata_len = static_cast<int>(zs.total_out);
  deflateEnd(&zs);

  int bsize = kHeaderLen + cdata_len + kFooterLen;
  if (bsize > 65536) return -1;
  const uint8_t header_fix[16] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0,
                                  0,    0xff, 6,    0,    66, 67, 2, 0};
  std::memcpy(dst, header_fix, 16);
  dst[16] = static_cast<uint8_t>((bsize - 1) & 0xff);
  dst[17] = static_cast<uint8_t>(((bsize - 1) >> 8) & 0xff);
  uint32_t crc = crc32(0, src, src_len);
  uint32_t isize = static_cast<uint32_t>(src_len);
  std::memcpy(dst + kHeaderLen + cdata_len, &crc, 4);
  std::memcpy(dst + kHeaderLen + cdata_len + 4, &isize, 4);
  return bsize;
}

int decompress_one(const uint8_t* src, int src_len, uint8_t* dst,
                   int dst_cap) {
  if (src_len < kHeaderLen + kFooterLen) return -1;
  const uint8_t* cdata = src + kHeaderLen;
  int cdata_len = src_len - kHeaderLen - kFooterLen;
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return -1;
  zs.next_in = const_cast<uint8_t*>(cdata);
  zs.avail_in = cdata_len;
  zs.next_out = dst;
  zs.avail_out = dst_cap;
  int rc = inflate(&zs, Z_FINISH);
  int out_len = static_cast<int>(zs.total_out);
  inflateEnd(&zs);
  if (rc != Z_STREAM_END) return -1;
  return out_len;
}

template <typename Fn>
void parallel_for(int n, int n_threads, Fn fn) {
  if (n_threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next{0};
  std::vector<std::thread> workers;
  int t = std::min(n_threads, n);
  workers.reserve(t);
  for (int w = 0; w < t; ++w) {
    workers.emplace_back([&]() {
      for (;;) {
        int i = next.fetch_add(1);
        if (i >= n) return;
        fn(i);
      }
    });
  }
  for (auto& th : workers) th.join();
}

}  // namespace

extern "C" {

// Compress n_blocks independent chunks into BGZF blocks.
// src: concatenated input; src_offsets/src_lens: per-block extents.
// dst: output buffer (caller provides 65536*n_blocks capacity);
// dst_lens: out, per-block compressed size (or -1 on failure).
// Returns total output bytes written when packed contiguously by caller.
int bgzf_compress_blocks(const uint8_t* src, const int64_t* src_offsets,
                         const int32_t* src_lens, int n_blocks, int level,
                         int n_threads, uint8_t* dst, int32_t* dst_lens) {
  parallel_for(n_blocks, n_threads, [&](int i) {
    dst_lens[i] = compress_one(src + src_offsets[i], src_lens[i],
                               dst + static_cast<int64_t>(i) * 65536, 65536,
                               level);
  });
  int64_t total = 0;
  for (int i = 0; i < n_blocks; ++i) {
    if (dst_lens[i] < 0) return -1;
    total += dst_lens[i];
  }
  return static_cast<int>(total);
}

// Decompress n_blocks BGZF blocks (given their extents in src) directly
// at caller-computed destination offsets (from the per-block ISIZE
// trailers), so Python neither over-allocates a 65536-strided scratch nor
// re-concatenates per-block slices.
int bgzf_decompress_blocks_at(const uint8_t* src, const int64_t* src_offsets,
                              const int32_t* src_lens, int n_blocks,
                              int n_threads, uint8_t* dst,
                              const int64_t* dst_offsets) {
  std::atomic<int> bad{0};
  parallel_for(n_blocks, n_threads, [&](int i) {
    const int cap =
        static_cast<int>(dst_offsets[i + 1] - dst_offsets[i]);
    const int got = decompress_one(src + src_offsets[i], src_lens[i],
                                   dst + dst_offsets[i], cap);
    if (got != cap) bad.store(1);
  });
  return bad.load() ? -1 : 0;
}

}  // extern "C"
