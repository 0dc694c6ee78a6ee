// Native datagram I/O pump for mediastreamer2_tpu_torch (a copy of the JAX
// package's native/io_pump.cpp with two changes, listed below).
//
// Role parity: the reference's receive path lives in oRTP's socket layer,
// polled from the ticker thread (rtp_session_recvm_with_ts); at thousands
// of batched legs a Python recv loop would serialize on the GIL and smear
// packet arrival timestamps. This pump owns an epoll loop on a dedicated
// thread: it drains every registered socket the moment data lands, stamps
// CLOCK_MONOTONIC nanoseconds (feeding jitter estimation), and parks
// packets in per-socket rings the Python tick loop empties in one batched
// call per tick.
//
// Changes from the JAX package's copy:
//  * a datagram longer than kMaxPacket is still cut to kMaxPacket bytes,
//    but it is counted: recv takes MSG_TRUNC, which makes it return the
//    datagram's real length, and ms2_pump_counters reports the count;
//  * add_socket forgets the socket again when epoll_ctl refuses it, and
//    ms2_pump_counters returns -1 for a socket the pump does not know.
//
// C ABI only (loaded via ctypes).

#include <atomic>
#include <memory>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#include <errno.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

namespace {

constexpr int kMaxPacket = 2048;
constexpr size_t kMaxQueuePerSocket = 4096;   // ~4k packets of backlog

struct Packet {
  uint64_t t_ns;
  uint32_t len;
  uint8_t data[kMaxPacket];
};

struct SocketQueue {
  std::mutex mu;
  std::deque<Packet> q;
  uint64_t dropped = 0;
  uint64_t truncated = 0;
};

uint64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return uint64_t(ts.tv_sec) * 1000000000ull + ts.tv_nsec;
}

class Pump {
 public:
  Pump() : epfd_(epoll_create1(0)), running_(true) {
    // self-pipe to wake the loop for add/remove/shutdown
    int fds[2];
    if (pipe(fds) == 0) {
      wake_r_ = fds[0];
      wake_w_ = fds[1];
      epoll_event ev{};
      ev.events = EPOLLIN;
      ev.data.fd = wake_r_;
      epoll_ctl(epfd_, EPOLL_CTL_ADD, wake_r_, &ev);
    }
    thread_ = std::thread([this] { loop(); });
  }

  ~Pump() {
    running_ = false;
    wake();
    if (thread_.joinable()) thread_.join();
    close(epfd_);
    close(wake_r_);
    close(wake_w_);
  }

  // 0, or -errno when epoll refuses the socket (which is then not kept).
  int add_socket(int fd) {
    {
      std::lock_guard<std::mutex> l(map_mu_);
      queues_.emplace(fd, std::make_shared<SocketQueue>());
    }
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = fd;
    if (epoll_ctl(epfd_, EPOLL_CTL_ADD, fd, &ev) != 0) {
      int err = errno;
      std::lock_guard<std::mutex> l(map_mu_);
      queues_.erase(fd);
      return -err;
    }
    wake();
    return 0;
  }

  int remove_socket(int fd) {
    epoll_ctl(epfd_, EPOLL_CTL_DEL, fd, nullptr);
    std::lock_guard<std::mutex> l(map_mu_);
    queues_.erase(fd);
    return 0;
  }

  // Copy out up to buflen bytes of framed packets:
  //   [uint64 t_ns][uint32 len][len bytes] ...
  // Returns bytes written, or -1 for a socket the pump does not know.
  int read(int fd, uint8_t* buf, int buflen) {
    std::shared_ptr<SocketQueue> sq = find(fd);
    if (!sq) return -1;
    int off = 0;
    std::lock_guard<std::mutex> l(sq->mu);
    while (!sq->q.empty()) {
      Packet& p = sq->q.front();
      int need = int(sizeof(uint64_t) + sizeof(uint32_t) + p.len);
      if (off + need > buflen) break;
      memcpy(buf + off, &p.t_ns, sizeof(uint64_t));
      off += sizeof(uint64_t);
      memcpy(buf + off, &p.len, sizeof(uint32_t));
      off += sizeof(uint32_t);
      memcpy(buf + off, p.data, p.len);
      off += p.len;
      sq->q.pop_front();
    }
    return off;
  }

  // Overflow drops and truncated datagrams of a socket; -1 if unknown.
  int counters(int fd, uint64_t* dropped, uint64_t* truncated) {
    std::shared_ptr<SocketQueue> sq = find(fd);
    if (!sq) return -1;
    std::lock_guard<std::mutex> l(sq->mu);
    *dropped = sq->dropped;
    *truncated = sq->truncated;
    return 0;
  }

 private:
  // Returns an owning reference: remove_socket() may erase the map entry
  // concurrently (e.g. UdpTransport.close() during a packet burst); the
  // shared_ptr keeps the queue alive until every user drops it, so the
  // epoll thread can never touch a destroyed SocketQueue.
  std::shared_ptr<SocketQueue> find(int fd) {
    std::lock_guard<std::mutex> l(map_mu_);
    auto it = queues_.find(fd);
    return it == queues_.end() ? nullptr : it->second;
  }

  void wake() {
    char c = 1;
    if (wake_w_ >= 0) { ssize_t r = write(wake_w_, &c, 1); (void)r; }
  }

  void loop() {
    std::vector<epoll_event> evs(64);
    while (running_) {
      int n = epoll_wait(epfd_, evs.data(), int(evs.size()), 100);
      if (n < 0) {
        if (errno == EINTR) continue;
        break;
      }
      uint64_t t = now_ns();
      for (int i = 0; i < n; i++) {
        int fd = evs[i].data.fd;
        if (fd == wake_r_) {
          char tmp[64];
          ssize_t r = ::read(wake_r_, tmp, sizeof tmp); (void)r;
          continue;
        }
        std::shared_ptr<SocketQueue> sq = find(fd);
        if (!sq) continue;
        // drain the socket completely (edge of the burst)
        for (;;) {
          Packet p;
          // MSG_TRUNC: the datagram's whole length, even past the buffer
          ssize_t len = recv(fd, p.data, kMaxPacket, MSG_DONTWAIT | MSG_TRUNC);
          if (len <= 0) break;
          bool cut = len > kMaxPacket;
          p.len = uint32_t(cut ? kMaxPacket : len);
          p.t_ns = t;
          std::lock_guard<std::mutex> l(sq->mu);
          if (cut) sq->truncated++;
          if (sq->q.size() >= kMaxQueuePerSocket) {
            sq->q.pop_front();       // overflow: drop oldest
            sq->dropped++;
          }
          sq->q.push_back(p);
        }
      }
    }
  }

  int epfd_;
  int wake_r_ = -1, wake_w_ = -1;
  std::atomic<bool> running_;
  std::thread thread_;
  std::mutex map_mu_;
  std::unordered_map<int, std::shared_ptr<SocketQueue>> queues_;
};

}  // namespace

extern "C" {

void* ms2_pump_create() { return new Pump(); }

void ms2_pump_destroy(void* p) { delete static_cast<Pump*>(p); }

int ms2_pump_add_socket(void* p, int fd) {
  return static_cast<Pump*>(p)->add_socket(fd);
}

int ms2_pump_remove_socket(void* p, int fd) {
  return static_cast<Pump*>(p)->remove_socket(fd);
}

int ms2_pump_read(void* p, int fd, uint8_t* buf, int buflen) {
  return static_cast<Pump*>(p)->read(fd, buf, buflen);
}

int ms2_pump_counters(void* p, int fd, uint64_t* dropped, uint64_t* truncated) {
  return static_cast<Pump*>(p)->counters(fd, dropped, truncated);
}

}  // extern "C"
