// Native runtime for the frame pipeline: bounded drop-oldest queues,
// a PNG decoder, and an ordered multi-threaded image prefetcher.
//
// The port's copy of d2slam_tpu/runtime/native/pipeline.cpp (the
// reference's bounded image queue that drops frames under load,
// d2frontend/src/d2frontend.cpp:70-153, drop when >2 pending at :81-84,
// and its threaded image ingestion, d2frontend.cpp:155-198). Built at
// first use by d2slam_tpu_torch/runtime/pipeline.py into the ignored
// d2slam_tpu_torch/_build/ under a hash of source and flags, and bound
// via ctypes:
//
//   g++ -O2 -fPIC -shared -o libpipeline-<hash>.so pipeline.cpp -lz -lpthread

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// bounded byte queue with drop-oldest policy + stats
// ---------------------------------------------------------------------------

struct FrameQueue {
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<std::vector<uint8_t>> items;
  size_t capacity;
  bool drop_oldest;
  bool closed = false;
  uint64_t pushed = 0, popped = 0, dropped = 0;
};

extern "C" void* fq_create(int capacity, int drop_oldest) {
  auto* q = new FrameQueue();
  q->capacity = capacity > 0 ? (size_t)capacity : 1;
  q->drop_oldest = drop_oldest != 0;
  return q;
}

extern "C" void fq_destroy(void* h) { delete (FrameQueue*)h; }

extern "C" void fq_close(void* h) {
  auto* q = (FrameQueue*)h;
  {
    std::lock_guard<std::mutex> lk(q->mu);
    q->closed = true;
  }
  q->cv_pop.notify_all();
  q->cv_push.notify_all();
}

// returns: 0 pushed, 1 pushed after dropping oldest, -1 rejected (full,
// no-drop policy), -2 closed
extern "C" int fq_push(void* h, const uint8_t* data, uint32_t len,
                       int block_ms) {
  auto* q = (FrameQueue*)h;
  std::unique_lock<std::mutex> lk(q->mu);
  if (q->closed) return -2;
  int rc = 0;
  if (q->items.size() >= q->capacity) {
    if (q->drop_oldest) {
      q->items.pop_front();
      q->dropped++;
      rc = 1;
    } else if (block_ms > 0) {
      bool ok = q->cv_push.wait_for(
          lk, std::chrono::milliseconds(block_ms),
          [&] { return q->items.size() < q->capacity || q->closed; });
      if (q->closed) return -2;
      if (!ok) return -1;
    } else {
      return -1;
    }
  }
  q->items.emplace_back(data, data + len);
  q->pushed++;
  lk.unlock();
  q->cv_pop.notify_one();
  return rc;
}

// returns payload length, or -1 on timeout, -2 if closed+empty,
// -3 if out buffer too small (item stays queued; *need = required size)
extern "C" int fq_pop(void* h, uint8_t* out, uint32_t cap, int timeout_ms,
                      uint32_t* need) {
  auto* q = (FrameQueue*)h;
  std::unique_lock<std::mutex> lk(q->mu);
  if (q->items.empty()) {
    if (q->closed) return -2;
    if (timeout_ms <= 0) return -1;
    bool ok = q->cv_pop.wait_for(
        lk, std::chrono::milliseconds(timeout_ms),
        [&] { return !q->items.empty() || q->closed; });
    if (q->items.empty()) return q->closed ? -2 : (ok ? -1 : -1);
  }
  auto& front = q->items.front();
  if (need) *need = (uint32_t)front.size();
  if (front.size() > cap) return -3;
  int len = (int)front.size();
  std::memcpy(out, front.data(), front.size());
  q->items.pop_front();
  q->popped++;
  lk.unlock();
  q->cv_push.notify_one();
  return len;
}

extern "C" int fq_size(void* h) {
  auto* q = (FrameQueue*)h;
  std::lock_guard<std::mutex> lk(q->mu);
  return (int)q->items.size();
}

extern "C" void fq_stats(void* h, uint64_t* pushed, uint64_t* popped,
                         uint64_t* dropped) {
  auto* q = (FrameQueue*)h;
  std::lock_guard<std::mutex> lk(q->mu);
  if (pushed) *pushed = q->pushed;
  if (popped) *popped = q->popped;
  if (dropped) *dropped = q->dropped;
}

// ---------------------------------------------------------------------------
// PNG decoder (8/16-bit grayscale, 8-bit RGB/RGBA, non-interlaced)
// ---------------------------------------------------------------------------

static uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | p[3];
}

static int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decodes a PNG byte stream. On success returns 0 and fills
// *w, *h, *channels, *bit_depth; `out` receives row-major samples
// (16-bit big-endian converted to native u16 when bit_depth == 16).
// out_cap is in bytes. Returns -3 if out too small (*need set).
extern "C" int png_decode(const uint8_t* buf, uint32_t len, uint8_t* out,
                          uint32_t out_cap, uint32_t* w, uint32_t* h,
                          uint32_t* channels, uint32_t* bit_depth,
                          uint32_t* need) {
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (len < 8 || std::memcmp(buf, sig, 8) != 0) return -1;
  uint32_t W = 0, H = 0, depth = 0, color = 0;
  std::vector<uint8_t> idat;
  size_t pos = 8;
  while (pos + 8 <= len) {
    uint32_t clen = be32(buf + pos);
    const uint8_t* type = buf + pos + 4;
    const uint8_t* data = buf + pos + 8;
    if (pos + 12 + clen > len) return -1;
    if (!std::memcmp(type, "IHDR", 4)) {
      W = be32(data);
      H = be32(data + 4);
      depth = data[8];
      color = data[9];
      if (data[12] != 0) return -4;  // interlaced unsupported
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + clen);
    } else if (!std::memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + clen;
  }
  if (!W || !H || idat.empty()) return -1;
  uint32_t ch;
  switch (color) {
    case 0: ch = 1; break;  // gray
    case 2: ch = 3; break;  // rgb
    case 4: ch = 2; break;  // gray+alpha
    case 6: ch = 4; break;  // rgba
    default: return -4;     // palette unsupported
  }
  if (depth != 8 && depth != 16) return -4;
  size_t bpp = ch * depth / 8;             // bytes per pixel
  size_t stride = W * bpp;                 // bytes per row (no filter byte)
  size_t raw_size = (stride + 1) * H;
  std::vector<uint8_t> raw(raw_size);
  uLongf dst_len = raw_size;
  if (uncompress(raw.data(), &dst_len, idat.data(), idat.size()) != Z_OK ||
      dst_len != raw_size)
    return -2;
  size_t out_size = stride * H;
  if (need) *need = (uint32_t)out_size;
  if (out_cap < out_size) return -3;
  // unfilter
  std::vector<uint8_t> prev(stride, 0);
  for (uint32_t y = 0; y < H; y++) {
    const uint8_t* src = raw.data() + y * (stride + 1);
    uint8_t filter = src[0];
    uint8_t* dst = out + y * stride;
    const uint8_t* up = y ? out + (y - 1) * stride : prev.data();
    for (size_t x = 0; x < stride; x++) {
      int a = x >= bpp ? dst[x - bpp] : 0;
      int b = up[x];
      int c = x >= bpp ? up[x - bpp] : 0;
      int v = src[x + 1];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return -4;
      }
      dst[x] = (uint8_t)v;
    }
  }
  if (depth == 16) {  // big-endian -> native u16
    for (size_t i = 0; i + 1 < out_size; i += 2) {
      uint8_t hi = out[i], lo = out[i + 1];
      uint16_t v = (uint16_t)((hi << 8) | lo);
      std::memcpy(out + i, &v, 2);
    }
  }
  if (w) *w = W;
  if (h) *h = H;
  if (channels) *channels = ch;
  if (bit_depth) *bit_depth = depth;
  return 0;
}

// ---------------------------------------------------------------------------
// ordered multi-threaded image prefetcher
// ---------------------------------------------------------------------------

struct Decoded {
  uint32_t w = 0, h = 0, ch = 0, depth = 0;
  std::vector<uint8_t> data;
  int status = 0;
};

struct Prefetcher {
  std::vector<std::string> paths;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv;
  std::map<size_t, Decoded> ready;  // decoded, awaiting ordered emit
  std::atomic<size_t> next_fetch{0};
  size_t next_emit = 0;
  size_t window;  // max decoded-ahead items held
  bool stop = false;
};

static void prefetch_worker(Prefetcher* p) {
  for (;;) {
    size_t idx = p->next_fetch.fetch_add(1);
    if (idx >= p->paths.size()) return;
    Decoded d;
    FILE* f = fopen(p->paths[idx].c_str(), "rb");
    std::vector<uint8_t> buf;
    if (f) {
      fseek(f, 0, SEEK_END);
      long n = ftell(f);
      fseek(f, 0, SEEK_SET);
      buf.resize(n > 0 ? (size_t)n : 0);
      if (n > 0 && fread(buf.data(), 1, (size_t)n, f) != (size_t)n)
        buf.clear();
      fclose(f);
    }
    if (buf.empty()) {
      d.status = -1;
    } else {
      uint32_t needb = 0;
      int rc = png_decode(buf.data(), (uint32_t)buf.size(), nullptr, 0,
                          &d.w, &d.h, &d.ch, &d.depth, &needb);
      if (rc == -3) {
        d.data.resize(needb);
        rc = png_decode(buf.data(), (uint32_t)buf.size(), d.data.data(),
                        needb, &d.w, &d.h, &d.ch, &d.depth, &needb);
      }
      d.status = rc;
    }
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv.wait(lk, [&] {
      return p->stop || idx < p->next_emit + p->window;
    });
    if (p->stop) return;
    p->ready.emplace(idx, std::move(d));
    p->cv.notify_all();
  }
}

extern "C" void* prefetch_create(const char** paths, int n_paths,
                                 int n_threads, int window) {
  auto* p = new Prefetcher();
  for (int i = 0; i < n_paths; i++) p->paths.emplace_back(paths[i]);
  p->window = window > 0 ? (size_t)window : 4;
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; i++)
    p->workers.emplace_back(prefetch_worker, p);
  return p;
}

// Pop the next image IN ORDER. Returns payload bytes written, or
// -1 timeout, -2 end of stream, -3 buffer too small (*need set),
// -4 decode error for this index (skipped; call again).
extern "C" int prefetch_next(void* h, uint8_t* out, uint32_t cap,
                             uint32_t* w, uint32_t* hgt, uint32_t* ch,
                             uint32_t* depth, int timeout_ms,
                             uint32_t* need) {
  auto* p = (Prefetcher*)h;
  std::unique_lock<std::mutex> lk(p->mu);
  if (p->next_emit >= p->paths.size()) return -2;
  bool ok = p->cv.wait_for(
      lk, std::chrono::milliseconds(timeout_ms > 0 ? timeout_ms : 1),
      [&] { return p->ready.count(p->next_emit) > 0 || p->stop; });
  auto it = p->ready.find(p->next_emit);
  if (it == p->ready.end()) return -1;
  Decoded& d = it->second;
  if (d.status != 0) {
    p->ready.erase(it);
    p->next_emit++;
    p->cv.notify_all();
    return -4;
  }
  if (need) *need = (uint32_t)d.data.size();
  if (d.data.size() > cap) return -3;
  int len = (int)d.data.size();
  std::memcpy(out, d.data.data(), d.data.size());
  if (w) *w = d.w;
  if (hgt) *hgt = d.h;
  if (ch) *ch = d.ch;
  if (depth) *depth = d.depth;
  p->ready.erase(it);
  p->next_emit++;
  lk.unlock();
  p->cv.notify_all();
  return len;
}

extern "C" void prefetch_destroy(void* h) {
  auto* p = (Prefetcher*)h;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
  }
  p->cv.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}
