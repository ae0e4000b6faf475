// Native UDP multicast transport for swarm keyframe/solver exchange.
//
// The port's copy of d2slam_tpu/comm/native/udp_transport.cpp, built
// into d2slam_tpu_torch/_build/ by comm/transport.py. Replaces the
// reference's LCM-over-UDP-multicast layer (reference:
// d2frontend/src/loop_net.cpp:10-22 setupNetwork on
// udpm://224.0.0.251:7667, d2vins/src/network/d2vins_net.cpp,
// d2comm/src/d2comm.cpp). Datagrams carry length-prefixed frames with
// a channel id; fragmentation/reassembly for payloads beyond one MTU
// is done here in C++ so the Python side only sees whole messages
// (mirroring loop_net.cpp's packet reassembly).
//
// Exposed as a C ABI for ctypes. Single-threaded, non-blocking
// receive with an internal reassembly table.

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <map>
#include <netinet/in.h>
#include <string>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint32_t kFragMagic = 0xF2A65EED;
constexpr size_t kMaxDatagram = 60000;  // payload bytes per fragment

struct FragHeader {
  uint32_t magic;
  uint32_t msg_id;
  uint16_t channel;
  uint16_t frag_idx;
  uint16_t frag_count;
  uint16_t sender;
} __attribute__((packed));

struct PendingMsg {
  std::vector<std::vector<uint8_t>> frags;
  size_t received = 0;
  double first_seen = 0;
};

double now_sec() {
  struct timeval tv;
  gettimeofday(&tv, nullptr);
  return tv.tv_sec + tv.tv_usec * 1e-6;
}

struct Transport {
  int fd = -1;
  sockaddr_in dest{};
  uint32_t next_msg_id = 1;
  uint16_t self_id = 0;
  double reassembly_timeout = 2.0;
  std::map<uint64_t, PendingMsg> pending;
  // last fully received message
  std::vector<uint8_t> out_buf;
  uint16_t out_channel = 0;
  uint16_t out_sender = 0;
};

// errno of the last failed create or send on this thread, for the
// caller's error message
thread_local int g_last_errno = 0;

void* fail_create(Transport* t) {
  g_last_errno = errno;
  if (t->fd >= 0) close(t->fd);
  delete t;
  return nullptr;
}

}  // namespace

extern "C" {

int udp_transport_errno() { return g_last_errno; }

void* udp_transport_create(const char* group, int port, uint16_t self_id,
                           int loopback) {
  auto* t = new Transport();
  t->self_id = self_id;
  t->fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (t->fd < 0) return fail_create(t);
  int reuse = 1;
  setsockopt(t->fd, SOL_SOCKET, SO_REUSEADDR, &reuse, sizeof(reuse));
  // multi-fragment keyframe bursts exceed the default ~212KB rcvbuf
  int rcvbuf = 8 * 1024 * 1024;
  setsockopt(t->fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
#ifdef SO_REUSEPORT
  setsockopt(t->fd, SOL_SOCKET, SO_REUSEPORT, &reuse, sizeof(reuse));
#endif
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(port);
  if (bind(t->fd, (sockaddr*)&addr, sizeof(addr)) < 0) return fail_create(t);
  ip_mreq mreq{};
  mreq.imr_multiaddr.s_addr = inet_addr(group);
  mreq.imr_interface.s_addr = htonl(INADDR_ANY);
  if (setsockopt(t->fd, IPPROTO_IP, IP_ADD_MEMBERSHIP, &mreq,
                 sizeof(mreq)) < 0)
    return fail_create(t);
  unsigned char loop = loopback ? 1 : 0;
  setsockopt(t->fd, IPPROTO_IP, IP_MULTICAST_LOOP, &loop, sizeof(loop));
  unsigned char ttl = 1;
  setsockopt(t->fd, IPPROTO_IP, IP_MULTICAST_TTL, &ttl, sizeof(ttl));

  t->dest.sin_family = AF_INET;
  t->dest.sin_addr.s_addr = inet_addr(group);
  t->dest.sin_port = htons(port);
  return t;
}

void udp_transport_destroy(void* h) {
  auto* t = static_cast<Transport*>(h);
  if (!t) return;
  if (t->fd >= 0) close(t->fd);
  delete t;
}

// Send one logical message on a channel; fragments transparently.
int udp_transport_send(void* h, uint16_t channel, const uint8_t* data,
                       uint32_t len) {
  auto* t = static_cast<Transport*>(h);
  if (!t) return -1;
  uint16_t frag_count =
      static_cast<uint16_t>((len + kMaxDatagram - 1) / kMaxDatagram);
  if (frag_count == 0) frag_count = 1;
  uint32_t msg_id = t->next_msg_id++;
  std::vector<uint8_t> buf;
  for (uint16_t i = 0; i < frag_count; i++) {
    size_t off = static_cast<size_t>(i) * kMaxDatagram;
    size_t n = len > off ? std::min(kMaxDatagram, (size_t)len - off) : 0;
    buf.resize(sizeof(FragHeader) + n);
    FragHeader hdr{kFragMagic, msg_id, channel, i, frag_count, t->self_id};
    memcpy(buf.data(), &hdr, sizeof(hdr));
    if (n) memcpy(buf.data() + sizeof(hdr), data + off, n);
    ssize_t sent = sendto(t->fd, buf.data(), buf.size(), 0,
                          (sockaddr*)&t->dest, sizeof(t->dest));
    if (sent < 0) { g_last_errno = errno; return -1; }
  }
  return 0;
}

// Poll for the next complete message. Returns payload length (>0) when a
// message completed, 0 if none pending, -1 on error. timeout_ms bounds
// the blocking wait for the FIRST datagram.
int udp_transport_recv(void* h, uint16_t* channel, uint16_t* sender,
                       uint8_t* out, uint32_t out_cap, int timeout_ms) {
  auto* t = static_cast<Transport*>(h);
  if (!t) return -1;

  // drop stale partial messages (reference recv_period timeout scan,
  // loop_net.cpp:364-440)
  double now = now_sec();
  for (auto it = t->pending.begin(); it != t->pending.end();) {
    if (now - it->second.first_seen > t->reassembly_timeout)
      it = t->pending.erase(it);
    else
      ++it;
  }

  uint8_t dgram[sizeof(FragHeader) + kMaxDatagram];
  for (;;) {
    struct timeval tv;
    tv.tv_sec = timeout_ms / 1000;
    tv.tv_usec = (timeout_ms % 1000) * 1000;
    fd_set rfds;
    FD_ZERO(&rfds);
    FD_SET(t->fd, &rfds);
    int r = select(t->fd + 1, &rfds, nullptr, nullptr, &tv);
    if (r <= 0) return 0;  // timeout / nothing
    ssize_t n = recv(t->fd, dgram, sizeof(dgram), 0);
    if (n < (ssize_t)sizeof(FragHeader)) continue;
    FragHeader hdr;
    memcpy(&hdr, dgram, sizeof(hdr));
    if (hdr.magic != kFragMagic) continue;
    if (hdr.sender == t->self_id) { timeout_ms = 0; continue; }  // self-msg

    uint64_t key = (uint64_t)hdr.sender << 32 | hdr.msg_id;
    auto& pm = t->pending[key];
    if (pm.frags.empty()) {
      pm.frags.resize(hdr.frag_count);
      pm.first_seen = now_sec();
    }
    if (hdr.frag_idx >= pm.frags.size()) continue;
    if (pm.frags[hdr.frag_idx].empty()) {
      pm.frags[hdr.frag_idx].assign(dgram + sizeof(hdr), dgram + n);
      pm.received++;
    }
    if (pm.received == pm.frags.size()) {
      size_t total = 0;
      for (auto& f : pm.frags) total += f.size();
      if (total > out_cap) { t->pending.erase(key); return -1; }
      size_t off = 0;
      for (auto& f : pm.frags) {
        memcpy(out + off, f.data(), f.size());
        off += f.size();
      }
      *channel = hdr.channel;
      *sender = hdr.sender;
      t->pending.erase(key);
      return (int)total;
    }
    timeout_ms = 0;  // keep draining without blocking again
  }
}

}  // extern "C"
