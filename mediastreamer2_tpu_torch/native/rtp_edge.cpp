// Batched RTP edge: the native host half of MSRtpSend/MSRtpRecv at scale.
//
// Role parity: the reference's RTP edge is C code running per tick per
// stream (src/otherfilters/msrtp.c:705-714 send, :1050-1091 recv + oRTP's
// socket layer and jitter buffer). At thousands of batched legs, a
// per-packet Python loop cannot meet the 10 ms tick: header packing,
// sendto/recvfrom syscalls and jitter-buffer inserts all serialize on the
// GIL. This module does the whole per-tick edge in three C calls:
//
//   tx_send(payload_matrix)   -> header pack + sendmmsg (per-msg dest addr)
//   rx_poll()                 -> recvmmsg drain + parse + jitter ring insert
//   rx_read_tick(out, flags)  -> per-leg playout pop into one [N,psz] matrix
//
// Jitter model: fixed-depth seq-indexed ring per leg with a packet-count
// prefill (the steady-state component of oRTP's adaptive buffer); depth
// adaptation decisions stay in Python (net/jitter.py) and apply here via
// rx_set_prefill/resync — value-reconfig, no rebuild.
//
// C ABI only (ctypes; no pybind11 in this image). Built by native/__init__.py.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#include <arpa/inet.h>
#include <dlfcn.h>
#include <errno.h>
#include <netinet/in.h>
#include <netinet/udp.h>
#include <sys/socket.h>
#include <unistd.h>

// Defines MS2_HW_CRYPTO when the build arch has AES-NI/SHA-NI/PCLMUL
// (-march=native on the build==run host); SrtpLeg then runs per-packet
// crypto with zero library calls instead of libcrypto EVP (~3x less
// per-packet time at SRTP sizes, tools/edge_profile.py).
#include "aesni_crypto.h"

#ifndef UDP_SEGMENT
#define UDP_SEGMENT 103
#endif
#ifndef UDP_GRO
#define UDP_GRO 104
#endif

namespace {

constexpr int kHdr = 12;
constexpr int kMmsgChunk = 512;

// ---------------------------------------------------------------------------
// WorkPool: persistent worker threads for leg-partitioned edge work.
//
// Role parity: the reference scales across host cores for free — one ticker
// THREAD per stream (src/base/msticker.c:448) runs header packing, libsrtp
// crypto and socket syscalls inside that stream's thread. The batched edge
// concentrates N legs' work into one call per tick, so to use >1 core it
// must shard the call: T workers each own a disjoint leg partition (their
// per-leg seq/ts/SRTP contexts are touched by exactly one worker, so the
// hot path stays lock-free). Syscalls (sendmmsg/sendmsg on one fd) are
// kernel-serialized and thread-safe.
// ---------------------------------------------------------------------------
class WorkPool {
 public:
  explicit WorkPool(int n_workers) : n_(n_workers) {
    for (int i = 0; i < n_; i++)
      threads_.emplace_back([this, i] { worker(i); });
  }

  ~WorkPool() {
    {
      std::lock_guard<std::mutex> lk(m_);
      stop_ = true;
    }
    cv_work_.notify_all();
    for (auto& t : threads_) t.join();
  }

  int workers() const { return n_; }

  // Run fn(part) for part in [0, n_); the caller blocks until all done.
  void run(const std::function<void(int)>& fn) {
    {
      std::lock_guard<std::mutex> lk(m_);
      fn_ = &fn;
      pending_ = n_;
      gen_++;
    }
    cv_work_.notify_all();
    std::unique_lock<std::mutex> lk(m_);
    cv_done_.wait(lk, [this] { return pending_ == 0; });
    fn_ = nullptr;
  }

 private:
  void worker(int part) {
    uint64_t seen = 0;
    for (;;) {
      const std::function<void(int)>* fn;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_work_.wait(lk, [&] { return stop_ || gen_ != seen; });
        if (stop_) return;
        seen = gen_;
        fn = fn_;
      }
      (*fn)(part);
      {
        std::lock_guard<std::mutex> lk(m_);
        if (--pending_ == 0) cv_done_.notify_all();
      }
    }
  }

  int n_;
  std::vector<std::thread> threads_;
  std::mutex m_;
  std::condition_variable cv_work_, cv_done_;
  const std::function<void(int)>* fn_ = nullptr;
  int pending_ = 0;
  uint64_t gen_ = 0;
  bool stop_ = false;
};

// ---------------------------------------------------------------------------
// SRTP AES-CM + HMAC-SHA1 via libcrypto (dlopen'd — no OpenSSL headers on
// this image). Role parity: the reference protects every packet inline in C
// through libsrtp2 RtpTransportModifier hooks (src/crypto/ms_srtp.cpp:475,
// 672,706,874); here protection rides the same batched tx/rx calls so N
// encrypted legs still cost three C calls per tick.
//
// Per-leg hot path (keys fixed per session):
//  * AES-CTR keystream = AES-ECB over counter blocks on a pre-keyed EVP ctx
//    (one EVP_EncryptUpdate per packet, no per-packet key schedule).
//  * HMAC-SHA1 from precomputed ipad/opad SHA1 midstates (two block
//    compressions saved per packet; sha_ni makes the rest ~250 ns).
// Session keys are derived in Python by the RFC-3711-KAT-validated KDF
// (net/srtp.py derive_key) and passed down — C never sees master keys.
// ---------------------------------------------------------------------------

struct EVP_CIPHER_CTX_;  // opaque
struct EVP_CIPHER_;      // opaque
// legacy SHA_CTX layout — frozen ABI since OpenSSL 0.9 (h0..h4,Nl,Nh,data,num)
struct Sha1Ctx {
  uint32_t h[5];
  uint32_t Nl, Nh;
  uint32_t data[16];
  unsigned num;
};

struct CryptoApi {
  EVP_CIPHER_CTX_* (*ctx_new)();
  void (*ctx_free)(EVP_CIPHER_CTX_*);
  const EVP_CIPHER_* (*aes128ecb)();
  const EVP_CIPHER_* (*aes256ecb)();
  const EVP_CIPHER_* (*aes128gcm)();
  const EVP_CIPHER_* (*aes256gcm)();
  int (*enc_init)(EVP_CIPHER_CTX_*, const EVP_CIPHER_*, void*, const uint8_t*,
                  const uint8_t*);
  int (*enc_final)(EVP_CIPHER_CTX_*, uint8_t*, int*);
  int (*dec_init)(EVP_CIPHER_CTX_*, const EVP_CIPHER_*, void*, const uint8_t*,
                  const uint8_t*);
  int (*dec_update)(EVP_CIPHER_CTX_*, uint8_t*, int*, const uint8_t*, int);
  int (*dec_final)(EVP_CIPHER_CTX_*, uint8_t*, int*);
  int (*ctx_ctrl)(EVP_CIPHER_CTX_*, int, int, void*);
  int (*set_padding)(EVP_CIPHER_CTX_*, int);
  int (*enc_update)(EVP_CIPHER_CTX_*, uint8_t*, int*, const uint8_t*, int);
  int (*sha1_init)(Sha1Ctx*);
  int (*sha1_update)(Sha1Ctx*, const void*, size_t);
  int (*sha1_final)(uint8_t*, Sha1Ctx*);
  bool ok = false;
};

constexpr int kCtrlGcmGetTag = 0x10;     // EVP_CTRL_AEAD_GET_TAG
constexpr int kCtrlGcmSetTag = 0x11;     // EVP_CTRL_AEAD_SET_TAG

const CryptoApi& crypto_api() {
  static CryptoApi api = [] {
    CryptoApi a{};
    void* h = dlopen("libcrypto.so.3", RTLD_NOW | RTLD_GLOBAL);
    if (!h) h = dlopen("libcrypto.so", RTLD_NOW | RTLD_GLOBAL);
    if (!h) h = dlopen("libcrypto.so.1.1", RTLD_NOW | RTLD_GLOBAL);
    if (!h) return a;
    auto sym = [&](const char* n) { return dlsym(h, n); };
    a.ctx_new = (EVP_CIPHER_CTX_ * (*)()) sym("EVP_CIPHER_CTX_new");
    a.ctx_free = (void (*)(EVP_CIPHER_CTX_*))sym("EVP_CIPHER_CTX_free");
    a.aes128ecb = (const EVP_CIPHER_* (*)()) sym("EVP_aes_128_ecb");
    a.aes256ecb = (const EVP_CIPHER_* (*)()) sym("EVP_aes_256_ecb");
    a.aes128gcm = (const EVP_CIPHER_* (*)()) sym("EVP_aes_128_gcm");
    a.aes256gcm = (const EVP_CIPHER_* (*)()) sym("EVP_aes_256_gcm");
    a.enc_init = (int (*)(EVP_CIPHER_CTX_*, const EVP_CIPHER_*, void*,
                          const uint8_t*, const uint8_t*))
        sym("EVP_EncryptInit_ex");
    a.enc_final =
        (int (*)(EVP_CIPHER_CTX_*, uint8_t*, int*))sym("EVP_EncryptFinal_ex");
    a.dec_init = (int (*)(EVP_CIPHER_CTX_*, const EVP_CIPHER_*, void*,
                          const uint8_t*, const uint8_t*))
        sym("EVP_DecryptInit_ex");
    a.dec_update = (int (*)(EVP_CIPHER_CTX_*, uint8_t*, int*, const uint8_t*,
                            int))sym("EVP_DecryptUpdate");
    a.dec_final =
        (int (*)(EVP_CIPHER_CTX_*, uint8_t*, int*))sym("EVP_DecryptFinal_ex");
    a.ctx_ctrl = (int (*)(EVP_CIPHER_CTX_*, int, int, void*))
        sym("EVP_CIPHER_CTX_ctrl");
    a.set_padding =
        (int (*)(EVP_CIPHER_CTX_*, int))sym("EVP_CIPHER_CTX_set_padding");
    a.enc_update = (int (*)(EVP_CIPHER_CTX_*, uint8_t*, int*, const uint8_t*,
                            int))sym("EVP_EncryptUpdate");
    a.sha1_init = (int (*)(Sha1Ctx*))sym("SHA1_Init");
    a.sha1_update = (int (*)(Sha1Ctx*, const void*, size_t))sym("SHA1_Update");
    a.sha1_final = (int (*)(uint8_t*, Sha1Ctx*))sym("SHA1_Final");
    a.ok = a.ctx_new && a.ctx_free && a.aes128ecb && a.aes256ecb &&
           a.aes128gcm && a.aes256gcm && a.enc_init && a.enc_final &&
           a.dec_init && a.dec_update && a.dec_final && a.ctx_ctrl &&
           a.set_padding && a.enc_update && a.sha1_init &&
           a.sha1_update && a.sha1_final;
    return a;
  }();
  return api;
}

constexpr int kMaxTag = 16;              // GCM tag (SHA1_80 = 10)

// One direction of one leg's SRTP session: AES_CM_{128,256}_HMAC_SHA1_{80,32}
// or AEAD_AES_{128,256}_GCM (RFC 7714)
struct SrtpLeg {
  EVP_CIPHER_CTX_* ecb = nullptr;        // pre-keyed AES-ECB / AES-GCM (k_e)
  uint8_t salt[14];                      // k_s (CM: 14 bytes; GCM: 12)
  Sha1Ctx inner, outer;                  // HMAC-SHA1(k_a) midstates (CM)
#if defined(MS2_HW_CRYPTO)
  ms2hw::AesKey hw_key;                  // CM keystream key schedule
  ms2hw::Sha1State hw_inner, hw_outer;   // CM HMAC midstates
  ms2hw::GcmKey hw_gcm;                  // GCM key schedule + GHASH key
#endif
  uint8_t tag_len = 0;                   // 10/4 (CM) or 16 (GCM); 0 = off
  uint8_t gcm = 0;
  uint32_t roc = 0;
  uint16_t last_seq = 0;
  uint8_t have_seq = 0;
  // RFC 3711 §3.3.2 replay list (rx only): 64-entry sliding bitmap over the
  // 48-bit packet index. The reference gets this from libsrtp2's
  // srtp_unprotect (ms_srtp.cpp rx path); here it runs after auth succeeds
  // and before the jitter-ring insert.
  uint64_t replay_top = 0;               // highest authenticated index
  uint64_t replay_mask = 0;              // bit d = (replay_top - d) seen
  uint8_t replay_started = 0;

  // Returns true if `index` is fresh (and marks it seen); false = replay.
  bool replay_check(uint64_t index) {
    if (!replay_started) {
      replay_started = 1;
      replay_top = index;
      replay_mask = 1;
      return true;
    }
    if (index > replay_top) {
      uint64_t shift = index - replay_top;
      replay_mask = shift >= 64 ? 0 : replay_mask << shift;
      replay_mask |= 1;
      replay_top = index;
      return true;
    }
    uint64_t delta = replay_top - index;
    if (delta >= 64) return false;       // older than the window: reject
    if (replay_mask & (uint64_t(1) << delta)) return false;  // seen
    replay_mask |= uint64_t(1) << delta;
    return true;
  }

  static constexpr int kMaxCtrBlocks = 64;

  bool init(const uint8_t* k_e, int k_e_len, const uint8_t* k_s,
            const uint8_t* k_a, int tlen, int payload_size,
            int use_gcm, int is_tx) {
    // reject payloads the fixed CTR scratch can't cover AT CONFIG TIME —
    // a runtime ctr_xor failure would otherwise tag-and-send plaintext
    if ((k_e_len != 16 && k_e_len != 32) || tlen > kMaxTag ||
        (payload_size + 15) / 16 > kMaxCtrBlocks)
      return false;
#if defined(MS2_HW_CRYPTO)
    (void)is_tx;                         // direction-free key schedules
    gcm = use_gcm ? 1 : 0;
    if (gcm) {
      if (tlen != 16) return false;      // RFC 7714 tags are 16 bytes
      ms2hw::gcm_expand(k_e, k_e_len, &hw_gcm);
      memset(salt, 0, sizeof salt);
      memcpy(salt, k_s, 12);
    } else {
      ms2hw::aes_expand(k_e, k_e_len, &hw_key);
      memcpy(salt, k_s, 14);
      ms2hw::hmac_midstates(k_a, 20, &hw_inner, &hw_outer);
    }
#else
    const CryptoApi& c = crypto_api();
    if (!c.ok) return false;
    if (!ecb) ecb = c.ctx_new();
    if (!ecb) return false;
    gcm = use_gcm ? 1 : 0;
    if (gcm) {
      if (tlen != 16) return false;      // RFC 7714 tags are 16 bytes
      const EVP_CIPHER_* ciph =
          k_e_len == 16 ? c.aes128gcm() : c.aes256gcm();
      // keyed once per session; per-packet re-init passes only the IV.
      // Direction is fixed per leg (tx encrypts, rx decrypts).
      int r = is_tx ? c.enc_init(ecb, ciph, nullptr, k_e, nullptr)
                    : c.dec_init(ecb, ciph, nullptr, k_e, nullptr);
      if (r != 1) return false;
      memset(salt, 0, sizeof salt);
      memcpy(salt, k_s, 12);
    } else {
      const EVP_CIPHER_* ciph = k_e_len == 16 ? c.aes128ecb() : c.aes256ecb();
      if (c.enc_init(ecb, ciph, nullptr, k_e, nullptr) != 1) return false;
      c.set_padding(ecb, 0);
      memcpy(salt, k_s, 14);
      uint8_t pad[64];
      for (int i = 0; i < 64; i++) pad[i] = (i < 20 ? k_a[i] : 0) ^ 0x36;
      c.sha1_init(&inner);
      c.sha1_update(&inner, pad, 64);
      for (int i = 0; i < 64; i++) pad[i] = (i < 20 ? k_a[i] : 0) ^ 0x5c;
      c.sha1_init(&outer);
      c.sha1_update(&outer, pad, 64);
    }
#endif
    // mid-call REKEY keeps the packet-index state: RFC 3711 ROC continues
    // across key changes on the same stream (only a fresh session resets)
    if (!tag_len) {
      roc = 0;
      have_seq = 0;
      replay_started = 0;
      replay_top = replay_mask = 0;
    }
    tag_len = uint8_t(tlen);
    return true;
  }

  void release() {
    if (ecb) crypto_api().ctx_free(ecb), ecb = nullptr;
    tag_len = 0;
  }

  // RFC 7714 §8.1 IV: 12 bytes = (00 00||SSRC||ROC||SEQ) XOR salt
  void gcm_iv(uint32_t ssrc, uint32_t roc_val, uint16_t seq,
              uint8_t* iv) const {
    memcpy(iv, salt, 12);
    iv[2] ^= uint8_t(ssrc >> 24);
    iv[3] ^= uint8_t(ssrc >> 16);
    iv[4] ^= uint8_t(ssrc >> 8);
    iv[5] ^= uint8_t(ssrc);
    iv[6] ^= uint8_t(roc_val >> 24);
    iv[7] ^= uint8_t(roc_val >> 16);
    iv[8] ^= uint8_t(roc_val >> 8);
    iv[9] ^= uint8_t(roc_val);
    iv[10] ^= uint8_t(seq >> 8);
    iv[11] ^= uint8_t(seq);
  }

  // In-place AEAD protect: header is AAD, payload -> ct, tag appended.
  bool gcm_protect(uint32_t ssrc, uint32_t roc_val, uint16_t seq,
                   uint8_t* pkt, int hdr_len, int payload_len) {
#if defined(MS2_HW_CRYPTO)
    uint8_t iv[12];
    gcm_iv(ssrc, roc_val, seq, iv);
    ms2hw::gcm_crypt(hw_gcm, iv, pkt, hdr_len, pkt + hdr_len, pkt + hdr_len,
                     payload_len, /*encrypt=*/true,
                     pkt + hdr_len + payload_len);
    return true;
#else
    const CryptoApi& c = crypto_api();
    uint8_t iv[12];
    gcm_iv(ssrc, roc_val, seq, iv);
    int outl = 0;
    if (c.enc_init(ecb, nullptr, nullptr, nullptr, iv) != 1) return false;
    if (c.enc_update(ecb, nullptr, &outl, pkt, hdr_len) != 1) return false;
    if (c.enc_update(ecb, pkt + hdr_len, &outl, pkt + hdr_len,
                     payload_len) != 1)
      return false;
    uint8_t fin[16];
    if (c.enc_final(ecb, fin, &outl) != 1) return false;
    return c.ctx_ctrl(ecb, kCtrlGcmGetTag, 16,
                      pkt + hdr_len + payload_len) == 1;
#endif
  }

  // Verify+decrypt payload into `out` (may differ from pkt). 1 = authentic.
  // `out` receives plaintext even on auth failure (same as EVP DecryptUpdate
  // before Final) — callers must discard it when this returns false.
  bool gcm_unprotect(uint32_t ssrc, uint32_t roc_val, uint16_t seq,
                     const uint8_t* pkt, int hdr_len, int payload_len,
                     uint8_t* out) {
#if defined(MS2_HW_CRYPTO)
    uint8_t iv[12], tag[16];
    gcm_iv(ssrc, roc_val, seq, iv);
    ms2hw::gcm_crypt(hw_gcm, iv, pkt, hdr_len, pkt + hdr_len, out,
                     payload_len, /*encrypt=*/false, tag);
    return ms2hw::tag_eq(tag, pkt + hdr_len + payload_len);
#else
    const CryptoApi& c = crypto_api();
    uint8_t iv[12], tag[16];
    memcpy(tag, pkt + hdr_len + payload_len, 16);
    gcm_iv(ssrc, roc_val, seq, iv);
    int outl = 0;
    if (c.dec_init(ecb, nullptr, nullptr, nullptr, iv) != 1) return false;
    if (c.ctx_ctrl(ecb, kCtrlGcmSetTag, 16, tag) != 1) return false;
    if (c.dec_update(ecb, nullptr, &outl, pkt, hdr_len) != 1) return false;
    if (c.dec_update(ecb, out, &outl, pkt + hdr_len, payload_len) != 1)
      return false;
    uint8_t fin[16];
    return c.dec_final(ecb, fin, &outl) == 1;
#endif
  }

  // RFC 3711 §4.1.1 IV, as counter blocks: salt||0x0000 ^ ssrc<<64 ^ index<<16
  void build_counters(uint32_t ssrc, uint64_t index, uint8_t* ctr,
                      int nblocks) const {
    uint8_t base[16];
    memcpy(base, salt, 14);
    base[14] = base[15] = 0;
    base[4] ^= uint8_t(ssrc >> 24);
    base[5] ^= uint8_t(ssrc >> 16);
    base[6] ^= uint8_t(ssrc >> 8);
    base[7] ^= uint8_t(ssrc);
    for (int i = 0; i < 6; i++)          // 48-bit index into bytes 8..13
      base[8 + i] ^= uint8_t(index >> (40 - 8 * i));
    for (int b = 0; b < nblocks; b++) {
      memcpy(ctr + 16 * b, base, 14);
      ctr[16 * b + 14] = uint8_t(b >> 8);
      ctr[16 * b + 15] = uint8_t(b);
    }
  }

  // XOR keystream for `len` payload bytes into buf (in place).
  // len <= kMaxCtrBlocks*16 is guaranteed by the init()-time check.
  bool ctr_xor(uint32_t ssrc, uint64_t index, uint8_t* buf, int len) {
    int nblocks = (len + 15) / 16;
    uint8_t ctr[kMaxCtrBlocks * 16], ks[kMaxCtrBlocks * 16];
    if (nblocks > kMaxCtrBlocks) return false;
    build_counters(ssrc, index, ctr, nblocks);
#if defined(MS2_HW_CRYPTO)
    ms2hw::aes_enc_blocks(hw_key, ctr, ks, nblocks);
#else
    const CryptoApi& c = crypto_api();
    int outl = 0;
    if (c.enc_update(ecb, ks, &outl, ctr, nblocks * 16) != 1) return false;
#endif
    for (int i = 0; i < len; i++) buf[i] ^= ks[i];
    return true;
  }

  // HMAC-SHA1(data || ROC)[:tag_len] from the midstates.
  void auth_tag(const uint8_t* data, int len, uint32_t roc_val, uint8_t* tag) {
#if defined(MS2_HW_CRYPTO)
    uint8_t digest[20];
    ms2hw::hmac_sha1_tag(hw_inner, hw_outer, data, len, roc_val, digest);
    memcpy(tag, digest, tag_len);
#else
    const CryptoApi& c = crypto_api();
    uint8_t rocb[4] = {uint8_t(roc_val >> 24), uint8_t(roc_val >> 16),
                       uint8_t(roc_val >> 8), uint8_t(roc_val)};
    uint8_t digest[20];
    Sha1Ctx s = inner;
    c.sha1_update(&s, data, size_t(len));
    c.sha1_update(&s, rocb, 4);
    c.sha1_final(digest, &s);
    Sha1Ctx o = outer;
    c.sha1_update(&o, digest, 20);
    c.sha1_final(digest, &o);
    memcpy(tag, digest, tag_len);
#endif
  }
};

// Introspection for tests/benches: 1 when this binary was compiled with
// the AES-NI/SHA-NI/PCLMUL per-packet path, 0 when it uses libcrypto EVP.
extern "C" int ms2_rtp_hw_crypto() {
#if defined(MS2_HW_CRYPTO)
  return 1;
#else
  return 0;
#endif
}

struct TxLeg {
  sockaddr_in dest{};
  uint32_t ssrc = 0;
  uint32_t ts = 0;
  uint16_t seq = 0;
  uint8_t pt = 0;
  uint8_t enabled = 0;
  SrtpLeg srtp;
};

// Per-worker send scratch: mmsg arrays + GSO staging (legs' frame bytes
// live in the shared frames_ arena, already disjoint per leg).
struct TxScratch {
  std::vector<iovec> iov;
  std::vector<mmsghdr> msgs;
  std::vector<uint8_t> gso_buf;
};

class RtpTx {
 public:
  RtpTx(int fd, int n, int psz)
      : fd_(fd), n_(n), psz_(psz), frames_(size_t(n) * (kHdr + psz + kMaxTag)),
        legs_(n), scratch_(1) {
    scratch_[0].iov.resize(kMmsgChunk);
    scratch_[0].msgs.resize(kMmsgChunk);
  }

  ~RtpTx() {
    for (TxLeg& l : legs_) l.srtp.release();
  }

  // Shard the send path over `t` worker threads (legs partitioned into
  // contiguous ranges; each worker owns its legs' seq/ts/SRTP state).
  void set_threads(int t) {
    if (t < 2) {
      pool_.reset();
      scratch_.resize(1);
      return;
    }
    pool_.reset(new WorkPool(t));
    scratch_.resize(t);
    for (TxScratch& s : scratch_) {
      s.iov.resize(kMmsgChunk);
      s.msgs.resize(kMmsgChunk);
      if (gso_) s.gso_buf.resize(size_t(kMaxSegs) * (kHdr + psz_ + kMaxTag));
    }
  }

  int set_srtp(int leg, const uint8_t* k_e, int k_e_len, const uint8_t* k_s,
               const uint8_t* k_a, int tag_len, int gcm) {
    return legs_[leg].srtp.init(k_e, k_e_len, k_s, k_a, tag_len, psz_,
                                gcm, /*is_tx=*/1) ? 1 : 0;
  }

  void config(int leg, const char* ip, int port, uint32_t ssrc, uint16_t seq0,
              uint32_t ts0, uint8_t pt) {
    TxLeg& l = legs_[leg];
    l.dest.sin_family = AF_INET;
    l.dest.sin_port = htons(uint16_t(port));
    inet_pton(AF_INET, ip, &l.dest.sin_addr);
    l.ssrc = ssrc;
    l.seq = seq0;
    l.ts = ts0;
    l.pt = pt;
    l.enabled = 1;
  }

  // UDP GSO fast path: all legs' packets ride one connected 4-tuple; the
  // kernel splits one big send into kMaxSegs equal datagrams (UDP_SEGMENT),
  // cutting syscalls + skb setup ~64x. Caller must connect() the socket.
  void set_gso(int on) {
    gso_ = on != 0;
    if (gso_)
      for (TxScratch& s : scratch_)
        if (s.gso_buf.empty())
          s.gso_buf.resize(size_t(kMaxSegs) * (kHdr + psz_ + kMaxTag));
  }

  // payloads: [n, psz] row-major; mask: per-leg send flag (nullptr = all).
  // ts advances for every enabled leg (DTX keeps the RTP clock running,
  // cf. rtp_session_sendm_with_ts timestamp semantics); seq only on send.
  int send(const uint8_t* payloads, const uint8_t* mask, uint32_t ts_inc) {
    if (pool_) {
      const int T = pool_->workers();
      std::vector<int> sent(size_t(T), 0);
      pool_->run([&](int part) {
        int lo = int(int64_t(n_) * part / T);
        int hi = int(int64_t(n_) * (part + 1) / T);
        sent[part] = gso_
            ? send_gso_range(lo, hi, payloads, mask, ts_inc, scratch_[part])
            : send_range(lo, hi, payloads, mask, ts_inc, scratch_[part]);
      });
      int total = 0;
      for (int s : sent) total += s;
      return total;
    }
    return gso_ ? send_gso_range(0, n_, payloads, mask, ts_inc, scratch_[0])
                : send_range(0, n_, payloads, mask, ts_inc, scratch_[0]);
  }

 private:
  int send_range(int lo, int hi, const uint8_t* payloads, const uint8_t* mask,
                 uint32_t ts_inc, TxScratch& sc) {
    int pending = 0, sent_total = 0;
    MacQueue mq;
    for (int i = lo; i < hi; i++) {
      TxLeg& l = legs_[i];
      if (i + 1 < hi) {                  // SrtpLeg is multi-line key state
        __builtin_prefetch(&legs_[i + 1].srtp, 0, 1);
        __builtin_prefetch(reinterpret_cast<const char*>(&legs_[i + 1].srtp) +
                           128, 0, 1);
      }
      if (!l.enabled) continue;
      if (mask && !mask[i]) {
        l.ts += ts_inc;
        continue;
      }
      uint8_t* f = frames_.data() + size_t(i) * (kHdr + psz_ + kMaxTag);
      f[0] = 0x80;                       // V=2, no P/X/CC
      f[1] = l.pt & 0x7F;
      f[2] = uint8_t(l.seq >> 8);
      f[3] = uint8_t(l.seq);
      f[4] = uint8_t(l.ts >> 24);
      f[5] = uint8_t(l.ts >> 16);
      f[6] = uint8_t(l.ts >> 8);
      f[7] = uint8_t(l.ts);
      f[8] = uint8_t(l.ssrc >> 24);
      f[9] = uint8_t(l.ssrc >> 16);
      f[10] = uint8_t(l.ssrc >> 8);
      f[11] = uint8_t(l.ssrc);
      memcpy(f + kHdr, payloads + size_t(i) * psz_, psz_);
      int flen = protect(l, f, mq);
      l.seq++;
      if (l.seq == 0) l.srtp.roc++;      // tx ROC on wrap (RFC 3711 §3.3.1)
      l.ts += ts_inc;

      sc.iov[pending] = {f, size_t(flen)};
      mmsghdr& m = sc.msgs[pending];
      memset(&m, 0, sizeof m);
      m.msg_hdr.msg_name = &l.dest;
      m.msg_hdr.msg_namelen = sizeof(sockaddr_in);
      m.msg_hdr.msg_iov = &sc.iov[pending];
      m.msg_hdr.msg_iovlen = 1;
      if (++pending == kMmsgChunk) {
        mac_flush(mq);                   // tags valid before the wire
        sent_total += flush(sc, pending);
        pending = 0;
      }
    }
    mac_flush(mq);
    if (pending) sent_total += flush(sc, pending);
    return sent_total;
  }

  static constexpr int kMaxSegs = 64;    // kernel UDP_MAX_SEGMENTS

#if defined(MS2_HW_CRYPTO)
  // Deferred CM auth tags, drained pairwise through the interleaved
  // 2-buffer SHA kernel (hmac_sha1_tag_x2).  All frames in a batch share
  // one authenticated length (kHdr + psz_), so any two pend entries pair.
  // MUST be drained (mac_flush) before the frames leave via sendmmsg/GSO.
  struct MacQueue {
    struct {
      const ms2hw::Sha1State* inner;
      const ms2hw::Sha1State* outer;
      const uint8_t* data;
      uint32_t roc;
      uint8_t* tag;
      uint8_t tag_len;
    } q[2];
    int n = 0;
  };

  void mac_flush(MacQueue& mq) {
    const int alen = kHdr + psz_;
    uint8_t d0[20], d1[20];
    if (mq.n == 2) {
      ms2hw::hmac_sha1_tag_x2(*mq.q[0].inner, *mq.q[0].outer, mq.q[0].data,
                              mq.q[0].roc, *mq.q[1].inner, *mq.q[1].outer,
                              mq.q[1].data, mq.q[1].roc, alen, d0, d1);
      memcpy(mq.q[0].tag, d0, mq.q[0].tag_len);
      memcpy(mq.q[1].tag, d1, mq.q[1].tag_len);
    } else if (mq.n == 1) {
      ms2hw::hmac_sha1_tag(*mq.q[0].inner, *mq.q[0].outer, mq.q[0].data, alen,
                           mq.q[0].roc, d0);
      memcpy(mq.q[0].tag, d0, mq.q[0].tag_len);
    }
    mq.n = 0;
  }
#else
  struct MacQueue {};
  void mac_flush(MacQueue&) {}
#endif

  // Encrypt payload in place + append auth tag; returns wire frame length.
  // CM tags are queued on `mq` (written at mac_flush time), not yet valid
  // on return.
  int protect(TxLeg& l, uint8_t* f, MacQueue& mq) {
    int flen = kHdr + psz_;
    if (!l.srtp.tag_len) return flen;
    if (l.srtp.gcm) {
      l.srtp.gcm_protect(l.ssrc, l.srtp.roc, l.seq, f, kHdr, psz_);
      return flen + 16;
    }
    uint64_t index = (uint64_t(l.srtp.roc) << 16) | l.seq;
    l.srtp.ctr_xor(l.ssrc, index, f + kHdr, psz_);
#if defined(MS2_HW_CRYPTO)
    mq.q[mq.n++] = {&l.srtp.hw_inner, &l.srtp.hw_outer, f, l.srtp.roc,
                    f + flen, l.srtp.tag_len};
    if (mq.n == 2) mac_flush(mq);
#else
    l.srtp.auth_tag(f, flen, l.srtp.roc, f + flen);
    (void)mq;
#endif
    return flen + l.srtp.tag_len;
  }

  int send_gso_range(int lo, int hi, const uint8_t* payloads,
                     const uint8_t* mask, uint32_t ts_inc, TxScratch& sc) {
    // GSO requires uniform segment size: all enabled legs must share one
    // tag_len (the batched-bench case); a mid-batch change flushes first.
    int in_buf = 0, sent_total = 0, frame = 0;
    MacQueue mq;
    for (int i = lo; i < hi; i++) {
      TxLeg& l = legs_[i];
      if (i + 1 < hi) {
        __builtin_prefetch(&legs_[i + 1].srtp, 0, 1);
        __builtin_prefetch(reinterpret_cast<const char*>(&legs_[i + 1].srtp) +
                           128, 0, 1);
      }
      if (!l.enabled) continue;
      if (mask && !mask[i]) {
        l.ts += ts_inc;
        continue;
      }
      int flen_i = kHdr + psz_ + l.srtp.tag_len;
      if (in_buf && flen_i != frame) {
        mac_flush(mq);
        sent_total += gso_flush(sc, in_buf, frame);
        in_buf = 0;
      }
      frame = flen_i;
      uint8_t* f = sc.gso_buf.data() + size_t(in_buf) * frame;
      f[0] = 0x80;
      f[1] = l.pt & 0x7F;
      f[2] = uint8_t(l.seq >> 8);
      f[3] = uint8_t(l.seq);
      f[4] = uint8_t(l.ts >> 24);
      f[5] = uint8_t(l.ts >> 16);
      f[6] = uint8_t(l.ts >> 8);
      f[7] = uint8_t(l.ts);
      f[8] = uint8_t(l.ssrc >> 24);
      f[9] = uint8_t(l.ssrc >> 16);
      f[10] = uint8_t(l.ssrc >> 8);
      f[11] = uint8_t(l.ssrc);
      memcpy(f + kHdr, payloads + size_t(i) * psz_, psz_);
      protect(l, f, mq);
      l.seq++;
      if (l.seq == 0) l.srtp.roc++;
      l.ts += ts_inc;
      if (++in_buf == kMaxSegs) {
        mac_flush(mq);
        sent_total += gso_flush(sc, in_buf, frame);
        in_buf = 0;
      }
    }
    mac_flush(mq);
    if (in_buf) sent_total += gso_flush(sc, in_buf, frame);
    return sent_total;
  }

  int gso_flush(TxScratch& sc, int nseg, int frame) {
    iovec iov{sc.gso_buf.data(), size_t(nseg) * frame};
    char ctrl[CMSG_SPACE(sizeof(uint16_t))] = {};
    msghdr m{};
    m.msg_iov = &iov;
    m.msg_iovlen = 1;
    if (nseg > 1) {
      m.msg_control = ctrl;
      m.msg_controllen = sizeof ctrl;
      cmsghdr* cm = CMSG_FIRSTHDR(&m);
      cm->cmsg_level = SOL_UDP;
      cm->cmsg_type = UDP_SEGMENT;
      cm->cmsg_len = CMSG_LEN(sizeof(uint16_t));
      uint16_t seg = uint16_t(frame);
      memcpy(CMSG_DATA(cm), &seg, sizeof seg);
    }
    for (;;) {
      ssize_t r = sendmsg(fd_, &m, 0);
      if (r >= 0) return nseg;
      if (errno == EINTR) continue;
      return 0;                          // EAGAIN burst: drop this chunk
    }
  }

  int flush(TxScratch& sc, int count) {
    int done = 0;
    while (done < count) {
      int r = sendmmsg(fd_, sc.msgs.data() + done, unsigned(count - done), 0);
      if (r <= 0) {
        if (errno == EINTR) continue;
        break;                           // EAGAIN under burst: drop remainder
      }
      done += r;
    }
    return done;
  }

  int fd_, n_, psz_;
  bool gso_ = false;
  std::vector<uint8_t> frames_;
  std::vector<TxLeg> legs_;
  std::vector<TxScratch> scratch_;
  std::unique_ptr<WorkPool> pool_;
};

struct RxLeg {
  uint16_t next_seq = 0;
  uint8_t primed = 0;
  uint8_t prefill = 2;                   // packets buffered before playout
  uint8_t warmup_left = 0;
  uint64_t got = 0, lost = 0, late = 0, recv = 0, auth_fail = 0;
  uint64_t replay_drops = 0;
  SrtpLeg srtp;
};

class RtpRx {
 public:
  RtpRx(int n, int psz, int depth)
      : n_(n), psz_(psz), depth_(depth),
        slot_seq_(size_t(n) * depth), slot_valid_(size_t(n) * depth, 0),
        slot_data_(size_t(n) * depth * psz), legs_(n) {
    // recvmmsg arena: 64 KiB buffers so a UDP_GRO-coalesced super-datagram
    // (up to ~700 tick packets of one flow) lands in one msg; per-msg
    // control space carries the kernel's UDP_GRO segment-size cmsg.
    bufs_.resize(size_t(kRxChunk) * kRxBuf);
    ctrl_.resize(size_t(kRxChunk) * kCtrl);
    iov_.resize(kRxChunk);
    msgs_.resize(kRxChunk);
    for (int i = 0; i < kRxChunk; i++) {
      iov_[i] = {bufs_.data() + size_t(i) * kRxBuf, kRxBuf};
      memset(&msgs_[i], 0, sizeof(mmsghdr));
      msgs_[i].msg_hdr.msg_iov = &iov_[i];
      msgs_[i].msg_hdr.msg_iovlen = 1;
      msgs_[i].msg_hdr.msg_control = ctrl_.data() + size_t(i) * kCtrl;
      msgs_[i].msg_hdr.msg_controllen = kCtrl;
    }
  }

  ~RtpRx() {
    for (RxLeg& l : legs_) l.srtp.release();
  }

  void add_fd(int fd) { fds_.push_back(fd); }

  void map_ssrc(uint32_t ssrc, int leg) { ssrc_to_leg_[ssrc] = leg; }

  // Shard verify+decrypt+insert and playout over `t` workers. Packets are
  // partitioned by leg (leg % t), so each RxLeg's SRTP/ring state is only
  // ever touched by one worker; the ssrc map is read-only on the hot path.
  void set_threads(int t) {
    if (t < 2) {
      pool_.reset();
      gcm_tmp_.resize(1);
    } else {
      pool_.reset(new WorkPool(t));
      gcm_tmp_.resize(t);
    }
    for (auto& s : gcm_tmp_)
      if (s.size() < size_t(psz_)) s.resize(psz_);
  }

  int set_srtp(int leg, const uint8_t* k_e, int k_e_len, const uint8_t* k_s,
               const uint8_t* k_a, int tag_len, int gcm) {
    for (auto& s : gcm_tmp_)
      if (gcm && s.size() < size_t(psz_)) s.resize(psz_);
    return legs_[leg].srtp.init(k_e, k_e_len, k_s, k_a, tag_len, psz_,
                                gcm, /*is_tx=*/0) ? 1 : 0;
  }

  uint64_t auth_failures(int leg) const { return legs_[leg].auth_fail; }

  uint64_t replay_drops(int leg) const { return legs_[leg].replay_drops; }

  void set_prefill(int leg, int k) {
    legs_[leg].prefill = uint8_t(k);
    legs_[leg].primed = 0;               // resync on next packet
  }

  int poll() {
    int total = 0;
    for (int fd : fds_) {
      for (;;) {
        for (int i = 0; i < kRxChunk; i++)
          msgs_[i].msg_hdr.msg_controllen = kCtrl;
        int r = recvmmsg(fd, msgs_.data(), kRxChunk, MSG_DONTWAIT, nullptr);
        if (r <= 0) break;
        // collect (ptr, len) segments (GRO super-datagrams split here),
        // then insert — sharded by leg across the pool when enabled (the
        // recvmmsg arena stays valid until the next recvmmsg call)
        segs_.clear();
        for (int i = 0; i < r; i++) {
          const uint8_t* buf = bufs_.data() + size_t(i) * kRxBuf;
          int len = int(msgs_[i].msg_len);
          int seg = gro_seg_size(msgs_[i].msg_hdr);
          if (seg <= 0 || seg >= len) {
            segs_.push_back({buf, len, leg_of(buf, len)});
          } else {                       // GRO: split coalesced datagrams
            for (int off = 0; off < len; off += seg) {
              int sl = len - off < seg ? len - off : seg;
              segs_.push_back({buf + off, sl, leg_of(buf + off, sl)});
            }
          }
        }
        total += int(segs_.size());
        if (pool_) {
          // routing (header parse + SSRC lookup) ran ONCE above on the
          // poll thread; workers shard only the crypto + ring insert —
          // per non-owned segment they pay one int compare, not a parse
          const int T = pool_->workers();
          pool_->run([&](int part) {
            drain_segs(gcm_tmp_[part],
                       [&](int leg) { return leg % T == part; });
          });
        } else {
          drain_segs(gcm_tmp_[0], [](int) { return true; });
        }
        if (r < kRxChunk) break;
      }
    }
    return total;
  }

  // out: [n, psz]; flags: 1 = packet present, 0 = missing (PLC on device).
  void read_tick(uint8_t* out, uint8_t* flags) {
    if (pool_) {
      const int T = pool_->workers();
      pool_->run([&](int part) {
        read_tick_range(int(int64_t(n_) * part / T),
                        int(int64_t(n_) * (part + 1) / T), out, flags);
      });
      return;
    }
    read_tick_range(0, n_, out, flags);
  }

  void read_tick_range(int lo, int hi, uint8_t* out, uint8_t* flags) {
    for (int i = lo; i < hi; i++) {
      RxLeg& l = legs_[i];
      uint8_t* dst = out + size_t(i) * psz_;
      if (!l.primed || l.warmup_left) {
        if (l.warmup_left) l.warmup_left--;
        memset(dst, 0, psz_);
        flags[i] = 0;
        continue;
      }
      size_t s = size_t(i) * depth_ + (l.next_seq & (depth_ - 1));
      if (slot_valid_[s] && slot_seq_[s] == l.next_seq) {
        memcpy(dst, slot_data_.data() + s * psz_, psz_);
        slot_valid_[s] = 0;
        flags[i] = 1;
        l.got++;
      } else {
        memset(dst, 0, psz_);
        flags[i] = 0;
        l.lost++;
      }
      l.next_seq++;
    }
  }

  void stats(int leg, uint64_t* got, uint64_t* lost, uint64_t* late,
             uint64_t* recv) const {
    const RxLeg& l = legs_[leg];
    *got = l.got;
    *lost = l.lost;
    *late = l.late;
    *recv = l.recv;
  }

 private:
  static constexpr int kRxChunk = 64;
  static constexpr int kRxBuf = 65536;
  static constexpr int kCtrl = 64;

  static int gro_seg_size(msghdr& mh) {
    for (cmsghdr* cm = CMSG_FIRSTHDR(&mh); cm; cm = CMSG_NXTHDR(&mh, cm)) {
      if (cm->cmsg_level == SOL_UDP && cm->cmsg_type == UDP_GRO) {
        int v;
        memcpy(&v, CMSG_DATA(cm), sizeof v);
        return v;
      }
    }
    return 0;
  }

  // Validate + route: -1 = not ours (bad version/length or unknown SSRC).
  int leg_of(const uint8_t* p, int len) const {
    if (len < kHdr + psz_ || (p[0] >> 6) != 2) return -1;
    uint32_t ssrc = (uint32_t(p[8]) << 24) | (uint32_t(p[9]) << 16) |
                    (uint32_t(p[10]) << 8) | p[11];
    auto it = ssrc_to_leg_.find(ssrc);
    return it == ssrc_to_leg_.end() ? -1 : it->second;
  }

  // Drain this worker's share of segs_, batching CM auth tags pairwise
  // through the interleaved 2-buffer SHA kernel.  A CM segment is held
  // until a second one arrives (or the chunk ends); digests computed at
  // a guessed ROC are handed to insert_leg, which accepts them only when
  // its own est_roc agrees (so intra-pair state changes stay sound and
  // the ROC-retry fallback is untouched).
  template <typename Owns>
  void drain_segs(std::vector<uint8_t>& gcm_tmp, Owns owns) {
    const Seg* pend = nullptr;
#if defined(MS2_HW_CRYPTO)
    uint32_t pend_roc = 0;
    int pend_alen = 0;
#endif
    for (const Seg& s : segs_) {
      if (s.leg < 0 || !owns(s.leg)) continue;
#if defined(MS2_HW_CRYPTO)
      RxLeg& l = legs_[s.leg];
      if (l.srtp.tag_len && !l.srtp.gcm &&
          s.len >= kHdr + psz_ + l.srtp.tag_len) {
        uint16_t seq = uint16_t((s.p[2] << 8) | s.p[3]);
        uint32_t roc = est_roc(l.srtp, seq);
        int alen = s.len - l.srtp.tag_len;
        if (!pend) {
          pend = &s;
          pend_roc = roc;
          pend_alen = alen;
          continue;
        }
        if (alen == pend_alen) {
          const RxLeg& pl = legs_[pend->leg];
          uint8_t d0[20], d1[20];
          ms2hw::hmac_sha1_tag_x2(pl.srtp.hw_inner, pl.srtp.hw_outer, pend->p,
                                  pend_roc, l.srtp.hw_inner, l.srtp.hw_outer,
                                  s.p, roc, alen, d0, d1);
          insert_leg(pend->leg, pend->p, pend->len, gcm_tmp, d0, pend_roc);
          insert_leg(s.leg, s.p, s.len, gcm_tmp, d1, roc);
          pend = nullptr;
          continue;
        }
        // length mismatch: settle the held one, hold this one
        insert_leg(pend->leg, pend->p, pend->len, gcm_tmp);
        pend = &s;
        pend_roc = roc;
        pend_alen = alen;
        continue;
      }
#endif
      insert_leg(s.leg, s.p, s.len, gcm_tmp);
    }
    if (pend) insert_leg(pend->leg, pend->p, pend->len, gcm_tmp);
  }

  void insert_leg(int leg, const uint8_t* p, int len,
                  std::vector<uint8_t>& gcm_tmp,
                  const uint8_t* pre_digest = nullptr, uint32_t pre_roc = 0) {
    uint32_t ssrc = (uint32_t(p[8]) << 24) | (uint32_t(p[9]) << 16) |
                    (uint32_t(p[10]) << 8) | p[11];
    RxLeg& l = legs_[leg];
    uint16_t seq = uint16_t((p[2] << 8) | p[3]);
    uint32_t roc = 0;
    bool gcm_decrypted = false;
    if (l.srtp.tag_len) {                // verify before touching any state
      if (len < kHdr + psz_ + l.srtp.tag_len) return;
      int alen = len - l.srtp.tag_len;
      roc = est_roc(l.srtp, seq);
      // resync-after-long-loss candidates: roc+1 always; roc-1 only when
      // it differs from the roc already tried (roc=0 would retry 0)
      uint32_t retry[2];
      int n_retry = 0;
      retry[n_retry++] = roc + 1;
      if (roc > 0) retry[n_retry++] = roc - 1;
      if (l.srtp.gcm) {
        // AEAD verify+decrypt into scratch; ROC ±1 resync like the CM path
        bool ok = l.srtp.gcm_unprotect(ssrc, roc, seq, p, kHdr, psz_,
                                       gcm_tmp.data());
        if (!ok) {
          for (int ri = 0; ri < n_retry; ri++) {
            if (l.srtp.gcm_unprotect(ssrc, retry[ri], seq, p, kHdr, psz_,
                                     gcm_tmp.data())) {
              roc = retry[ri];
              ok = true;
              break;
            }
          }
        }
        if (!ok) {
          l.auth_fail++;
          return;
        }
        gcm_decrypted = true;
      } else {
        uint8_t tag[kMaxTag];
        bool first_ok;
        if (pre_digest && pre_roc == roc) {
          // pairwise pre-verified digest (drain_segs), same ROC guess
          first_ok = memcmp(pre_digest, p + alen, l.srtp.tag_len) == 0;
        } else {
          l.srtp.auth_tag(p, alen, roc, tag);
          first_ok = memcmp(tag, p + alen, l.srtp.tag_len) == 0;
        }
        if (!first_ok) {
          bool ok = false;
          for (int ri = 0; ri < n_retry; ri++) {
            l.srtp.auth_tag(p, alen, retry[ri], tag);
            if (memcmp(tag, p + alen, l.srtp.tag_len) == 0) {
              roc = retry[ri];
              ok = true;
              break;
            }
          }
          if (!ok) {
            l.auth_fail++;
            return;
          }
        }
      }
      // authenticated: reject replays before any state is touched
      // (RFC 3711 §3.3.2; the reference relies on libsrtp2's replay list)
      if (!l.srtp.replay_check((uint64_t(roc) << 16) | seq)) {
        l.replay_drops++;
        return;
      }
    }
    l.recv++;
    if (!l.primed) {
      l.primed = 1;
      l.next_seq = seq;
      l.warmup_left = l.prefill;
    } else if (int16_t(seq - l.next_seq) < 0) {
      l.late++;                          // playout already passed this seq
      return;
    }
    size_t s = size_t(leg) * depth_ + (seq & (depth_ - 1));
    slot_seq_[s] = seq;
    slot_valid_[s] = 1;
    uint8_t* dst = slot_data_.data() + s * psz_;
    if (gcm_decrypted) {
      memcpy(dst, gcm_tmp.data(), psz_);
    } else {
      memcpy(dst, p + kHdr, psz_);
    }
    if (l.srtp.tag_len) {
      if (!l.srtp.gcm) {                 // CM: decrypt in the ring slot
        uint64_t index = (uint64_t(roc) << 16) | seq;
        l.srtp.ctr_xor(ssrc, index, dst, psz_);
      }
      // advance the index-estimation anchor (RFC 3711 §3.3.1 update rule)
      if (!l.srtp.have_seq || int16_t(seq - l.srtp.last_seq) > 0 ||
          roc > l.srtp.roc) {
        l.srtp.last_seq = seq;
        l.srtp.roc = roc;
        l.srtp.have_seq = 1;
      }
    }
  }

  static uint32_t est_roc(const SrtpLeg& s, uint16_t seq) {
    if (!s.have_seq) return s.roc;
    int s_l = s.last_seq, sq = seq;
    if (s_l < 32768)
      return (sq - s_l > 32768 && s.roc) ? s.roc - 1 : s.roc;
    return (s_l - sq > 32768) ? s.roc + 1 : s.roc;
  }

  int n_, psz_, depth_;
  std::vector<int> fds_;
  std::unordered_map<uint32_t, int> ssrc_to_leg_;
  std::vector<uint16_t> slot_seq_;
  std::vector<uint8_t> slot_valid_;
  std::vector<uint8_t> slot_data_;
  std::vector<RxLeg> legs_;
  struct Seg {
    const uint8_t* p;
    int len;
    int leg;                             // routed once on the poll thread
  };
  std::vector<Seg> segs_;                // per-recvmmsg-chunk segment list
  std::vector<std::vector<uint8_t>> gcm_tmp_{1};  // per-worker AEAD scratch
  std::unique_ptr<WorkPool> pool_;
  std::vector<uint8_t> bufs_;
  std::vector<uint8_t> ctrl_;
  std::vector<iovec> iov_;
  std::vector<mmsghdr> msgs_;
};

}  // namespace

extern "C" {

void* ms2_rtptx_create(int fd, int n_legs, int payload_size) {
  return new RtpTx(fd, n_legs, payload_size);
}
void ms2_rtptx_destroy(void* p) { delete static_cast<RtpTx*>(p); }
void ms2_rtptx_config(void* p, int leg, const char* ip, int port,
                      uint32_t ssrc, uint16_t seq0, uint32_t ts0, uint8_t pt) {
  static_cast<RtpTx*>(p)->config(leg, ip, port, ssrc, seq0, ts0, pt);
}
int ms2_rtptx_send(void* p, const uint8_t* payloads, const uint8_t* mask,
                   uint32_t ts_inc) {
  return static_cast<RtpTx*>(p)->send(payloads, mask, ts_inc);
}
void ms2_rtptx_set_gso(void* p, int on) {
  static_cast<RtpTx*>(p)->set_gso(on);
}
void ms2_rtptx_set_threads(void* p, int t) {
  static_cast<RtpTx*>(p)->set_threads(t);
}
int ms2_rtptx_set_srtp(void* p, int leg, const uint8_t* k_e, int k_e_len,
                       const uint8_t* k_s, const uint8_t* k_a, int tag_len,
                       int gcm) {
  return static_cast<RtpTx*>(p)->set_srtp(leg, k_e, k_e_len, k_s, k_a,
                                          tag_len, gcm);
}

void* ms2_rtprx_create(int n_legs, int payload_size, int ring_depth) {
  return new RtpRx(n_legs, payload_size, ring_depth);
}
void ms2_rtprx_destroy(void* p) { delete static_cast<RtpRx*>(p); }
void ms2_rtprx_add_fd(void* p, int fd) { static_cast<RtpRx*>(p)->add_fd(fd); }
void ms2_rtprx_map_ssrc(void* p, uint32_t ssrc, int leg) {
  static_cast<RtpRx*>(p)->map_ssrc(ssrc, leg);
}
void ms2_rtprx_set_prefill(void* p, int leg, int k) {
  static_cast<RtpRx*>(p)->set_prefill(leg, k);
}
void ms2_rtprx_set_threads(void* p, int t) {
  static_cast<RtpRx*>(p)->set_threads(t);
}
int ms2_rtprx_poll(void* p) { return static_cast<RtpRx*>(p)->poll(); }
void ms2_rtprx_read_tick(void* p, uint8_t* out, uint8_t* flags) {
  static_cast<RtpRx*>(p)->read_tick(out, flags);
}
void ms2_rtprx_stats(void* p, int leg, uint64_t* got, uint64_t* lost,
                     uint64_t* late, uint64_t* recv) {
  static_cast<RtpRx*>(p)->stats(leg, got, lost, late, recv);
}
int ms2_rtprx_set_srtp(void* p, int leg, const uint8_t* k_e, int k_e_len,
                       const uint8_t* k_s, const uint8_t* k_a, int tag_len,
                       int gcm) {
  return static_cast<RtpRx*>(p)->set_srtp(leg, k_e, k_e_len, k_s, k_a,
                                          tag_len, gcm);
}
uint64_t ms2_rtprx_auth_failures(void* p, int leg) {
  return static_cast<RtpRx*>(p)->auth_failures(leg);
}
uint64_t ms2_rtprx_replay_drops(void* p, int leg) {
  return static_cast<RtpRx*>(p)->replay_drops(leg);
}

}  // extern "C"
