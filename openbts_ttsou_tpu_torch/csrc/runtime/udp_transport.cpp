// UDP datagram transport with a handle table.
// Mirrors the behavior of CommonLibs/Sockets.cpp (UDPSocket: bind local
// port, fixed remote destination, blocking reads with timeout) without
// the C++ class surface. Reads wait with poll(), which takes any
// descriptor; select() takes only those below FD_SETSIZE (1024).
#include "runtime.h"

#include <arpa/inet.h>
#include <cerrno>
#include <chrono>
#include <cstring>
#include <mutex>
#include <netdb.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

namespace {

struct Conn {
  int fd = -1;
  sockaddr_storage remote{};
  socklen_t remote_len = 0;
  bool used = false;
};

// One ARFCN needs 2 planes + 1 clock; a 1024-carrier daemon needs
// thousands of handles (the reference runs one process per ARFCN and
// never needed more than a few, runTransceiver.cpp:68-74). A soak that
// holds the BTS side in the same process takes 4 * 1024 + 2 at 1024
// carriers (the daemon's and the stub's control and data sockets and
// their clock sockets), past the 4096 of the JAX package's table.
constexpr int kMax = 8192;
Conn g_conns[kMax];
std::mutex g_lock;

}  // namespace

extern "C" int udt_open(int local_port, const char *remote_host,
                        int remote_port) {
  int fd = ::socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  // A 13-frame burst batch is ~16 KB per plane, but bursty multi-block
  // backlogs overflow the default rmem quickly (each datagram costs
  // ~768 bytes of kernel overhead). Try the privileged force first.
  int buf = 4 << 20;
  if (::setsockopt(fd, SOL_SOCKET, SO_RCVBUFFORCE, &buf, sizeof(buf)) < 0)
    ::setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &buf, sizeof(buf));
  if (::setsockopt(fd, SOL_SOCKET, SO_SNDBUFFORCE, &buf, sizeof(buf)) < 0)
    ::setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &buf, sizeof(buf));
  sockaddr_in local{};
  local.sin_family = AF_INET;
  local.sin_addr.s_addr = htonl(INADDR_ANY);
  local.sin_port = htons((uint16_t)local_port);
  if (::bind(fd, (sockaddr *)&local, sizeof(local)) < 0) {
    ::close(fd);
    return -1;
  }
  sockaddr_in remote{};
  remote.sin_family = AF_INET;
  remote.sin_port = htons((uint16_t)remote_port);
  if (remote_host && remote_host[0]) {
    hostent *he = ::gethostbyname(remote_host);
    if (!he) {
      ::close(fd);
      return -1;
    }
    std::memcpy(&remote.sin_addr, he->h_addr_list[0], he->h_length);
  }
  std::lock_guard<std::mutex> g(g_lock);
  for (int i = 0; i < kMax; i++) {
    if (!g_conns[i].used) {
      g_conns[i].fd = fd;
      std::memcpy(&g_conns[i].remote, &remote, sizeof(remote));
      g_conns[i].remote_len = sizeof(remote);
      g_conns[i].used = true;
      return i;
    }
  }
  ::close(fd);
  return -1;
}

// Unix-domain datagram variant (CommonLibs UDDSocket, Sockets.h:157).
extern "C" int udt_open_unix(const char *local_path,
                             const char *remote_path) {
  int fd = ::socket(AF_UNIX, SOCK_DGRAM, 0);
  if (fd < 0) return -1;
  sockaddr_un local{};
  local.sun_family = AF_UNIX;
  std::strncpy(local.sun_path, local_path, sizeof(local.sun_path) - 1);
  ::unlink(local_path);
  if (::bind(fd, (sockaddr *)&local, sizeof(local)) < 0) {
    ::close(fd);
    return -1;
  }
  sockaddr_un remote{};
  remote.sun_family = AF_UNIX;
  if (remote_path && remote_path[0])
    std::strncpy(remote.sun_path, remote_path, sizeof(remote.sun_path) - 1);
  std::lock_guard<std::mutex> g(g_lock);
  for (int i = 0; i < kMax; i++) {
    if (!g_conns[i].used) {
      g_conns[i].fd = fd;
      std::memcpy(&g_conns[i].remote, &remote, sizeof(remote));
      g_conns[i].remote_len = sizeof(remote);
      g_conns[i].used = true;
      return i;
    }
  }
  ::close(fd);
  return -1;
}

extern "C" int udt_send(int h, const void *buf, int len) {
  if (h < 0 || h >= kMax || !g_conns[h].used) return -1;
  return (int)::sendto(g_conns[h].fd, buf, (size_t)len, 0,
                       (sockaddr *)&g_conns[h].remote,
                       g_conns[h].remote_len);
}

extern "C" int udt_recv(int h, void *buf, int maxlen, int timeout_ms) {
  if (h < 0 || h >= kMax || !g_conns[h].used) return -1;
  int fd = g_conns[h].fd;
  if (timeout_ms >= 0) {
    using clock = std::chrono::steady_clock;
    const auto end = clock::now() + std::chrono::milliseconds(timeout_ms);
    pollfd pfd{fd, POLLIN, 0};
    int wait_ms = timeout_ms;
    for (;;) {
      int rc = ::poll(&pfd, 1, wait_ms);
      if (rc > 0) break;
      if (rc == 0) return 0;  // timeout
      if (errno != EINTR) return -1;
      // interrupted: wait again for what is left of the timeout
      auto left = std::chrono::ceil<std::chrono::milliseconds>(
          end - clock::now()).count();
      if (left <= 0) return 0;
      wait_ms = (int)left;
    }
  }
  ssize_t n = ::recv(fd, buf, (size_t)maxlen, 0);
  return (int)n;
}

// Send n_pkts fixed-size packets laid out back-to-back in pkts — one
// sendmmsg syscall per 512 datagrams. The block-pipelined daemon emits
// every burst of a 13-frame window in one call per carrier: at 128
// carriers × 8 slots the wire moves ~440k datagrams/s, which only fits
// the frame budget with batched syscalls (the reference writes one
// datagram per burst from its FIFO service thread,
// Transceiver52M/Transceiver.cpp:652-667 — at 1 ARFCN that was fine).
// Returns packets sent.
extern "C" int udt_send_batch(int h, const uint8_t *pkts, int n_pkts,
                              int pkt_len) {
  if (h < 0 || h >= kMax || !g_conns[h].used || pkt_len <= 0) return -1;
  constexpr int kBatch = 512;
  iovec iov[kBatch];
  mmsghdr msgs[kBatch];
  int sent = 0;
  while (sent < n_pkts) {
    int n = n_pkts - sent;
    if (n > kBatch) n = kBatch;
    for (int i = 0; i < n; i++) {
      iov[i] = {const_cast<uint8_t *>(pkts) + (size_t)(sent + i) * pkt_len,
                (size_t)pkt_len};
      msgs[i] = {};
      msgs[i].msg_hdr.msg_name = &g_conns[h].remote;
      msgs[i].msg_hdr.msg_namelen = g_conns[h].remote_len;
      msgs[i].msg_hdr.msg_iov = &iov[i];
      msgs[i].msg_hdr.msg_iovlen = 1;
    }
    int rc = ::sendmmsg(g_conns[h].fd, msgs, (unsigned)n, 0);
    if (rc <= 0) break;
    sent += rc;
    if (rc < n) break;
  }
  return sent;
}

// Drain every queued datagram of exactly pkt_len bytes into out
// (back-to-back) without blocking — one recvmmsg syscall per 512.
// Datagrams of any other length are discarded (the reference's
// driveTransmitPriorityQueue also drops malformed bursts). Returns the
// number of packets written to out.
extern "C" int udt_drain_fixed(int h, int pkt_len, int max_pkts,
                               uint8_t *out) {
  if (h < 0 || h >= kMax || !g_conns[h].used || pkt_len <= 0) return -1;
  int fd = g_conns[h].fd;
  constexpr int kBatch = 512;
  iovec iov[kBatch];
  mmsghdr msgs[kBatch];
  int got = 0;
  while (got < max_pkts) {
    int want = max_pkts - got;
    if (want > kBatch) want = kBatch;
    for (int i = 0; i < want; i++) {
      iov[i] = {out + (size_t)(got + i) * pkt_len, (size_t)pkt_len};
      msgs[i] = {};
      msgs[i].msg_hdr.msg_iov = &iov[i];
      msgs[i].msg_hdr.msg_iovlen = 1;
    }
    const int base = got;
    int rc = ::recvmmsg(fd, msgs, (unsigned)want, MSG_DONTWAIT, nullptr);
    if (rc <= 0) break;
    // compact wrong-length datagrams out in place
    for (int i = 0; i < rc; i++) {
      if ((int)msgs[i].msg_len != pkt_len) continue;
      if (got != base + i)
        std::memmove(out + (size_t)got * pkt_len,
                     out + (size_t)(base + i) * pkt_len, (size_t)pkt_len);
      ++got;
    }
    if (rc < want) break;
  }
  return got;
}

extern "C" void udt_close(int h) {
  std::lock_guard<std::mutex> g(g_lock);
  if (h >= 0 && h < kMax && g_conns[h].used) {
    ::close(g_conns[h].fd);
    g_conns[h].used = false;
  }
}
