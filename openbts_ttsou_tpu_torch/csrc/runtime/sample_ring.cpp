// Timestamped complex-int16 sample ring buffer.
// Mirrors the behavior of the reference's USRP receive ring
// (Transceiver52M/USRPDevice.{h,cpp}: a power-of-two ring of interleaved
// I/Q int16 samples addressed by a 64-bit sample timestamp, with gaps
// zero-filled and stale reads clamped).
#include "runtime.h"

#include <algorithm>
#include <cstring>
#include <mutex>
#include <vector>

struct sample_ring {
  std::vector<int16_t> buf;  // 2*capacity int16
  size_t cap = 0;            // samples
  int64_t start = -1;        // oldest valid timestamp
  int64_t end = -1;          // next timestamp to write
  // 32->64-bit timestamp extension state for the packet path
  // (USRPDevice.h:80-82 hi32Timestamp/lastPktTimestamp)
  uint32_t hi32 = 0;
  int64_t last_pkt_ts = -1;  // extended; -1 = no packet seen yet
  std::mutex lock;
};

extern "C" sample_ring *ring_create(size_t capacity_samples) {
  auto *r = new sample_ring;
  r->cap = capacity_samples;
  r->buf.assign(2 * capacity_samples, 0);
  return r;
}

extern "C" void ring_destroy(sample_ring *r) { delete r; }

static inline size_t slot(const sample_ring *r, int64_t ts) {
  int64_t m = ts % (int64_t)r->cap;
  return (size_t)(m < 0 ? m + (int64_t)r->cap : m);
}

extern "C" int64_t ring_write(sample_ring *r, const int16_t *iq, int64_t n,
                              int64_t ts) {
  if (!r || n <= 0) return 0;
  std::lock_guard<std::mutex> g(r->lock);
  if (r->start < 0) {
    r->start = ts;
    r->end = ts;
  }
  // zero-fill a gap between end and ts (timestamp jump, like the
  // reference's underrun/overrun handling)
  if (ts > r->end) {
    int64_t gap = std::min<int64_t>(ts - r->end, (int64_t)r->cap);
    for (int64_t i = 0; i < gap; i++) {
      size_t s = slot(r, r->end + i);
      r->buf[2 * s] = 0;
      r->buf[2 * s + 1] = 0;
    }
  }
  for (int64_t i = 0; i < n; i++) {
    size_t s = slot(r, ts + i);
    r->buf[2 * s] = iq[2 * i];
    r->buf[2 * s + 1] = iq[2 * i + 1];
  }
  r->end = std::max(r->end, ts + n);
  r->start = std::max(r->start, r->end - (int64_t)r->cap);
  return n;
}

extern "C" int64_t ring_read(sample_ring *r, int16_t *iq_out, int64_t n,
                             int64_t ts) {
  if (!r || n <= 0) return 0;
  std::lock_guard<std::mutex> g(r->lock);
  std::memset(iq_out, 0, (size_t)(2 * n * sizeof(int16_t)));
  if (r->start < 0) return 0;
  int64_t lo = std::max(ts, r->start);
  int64_t hi = std::min(ts + n, r->end);
  if (hi <= lo) return (ts >= r->end || ts + n <= r->start) ? -1 : 0;
  for (int64_t t = lo; t < hi; t++) {
    size_t s = slot(r, t);
    iq_out[2 * (t - ts)] = r->buf[2 * s];
    iq_out[2 * (t - ts) + 1] = r->buf[2 * s + 1];
  }
  return hi - lo;
}

extern "C" int64_t ring_end_ts(const sample_ring *r) {
  return r ? r->end : -1;
}
extern "C" int64_t ring_start_ts(const sample_ring *r) {
  return r ? r->start : -1;
}

// ---------------------------------------------------------------------
// USRP-format packet reassembly with 32->64-bit timestamp extension.
// Mirrors USRPDevice::readSamples (Transceiver52M/USRPDevice.cpp:
// 318-410): the wire carries 512-byte packets whose header is
//   word0: payload bytes in bits 0-8, channel in bits 16-20, RSSI in
//          bits 21-26, underrun flag at bit 30 ((word0 >> 28) & 0x4)
//   word1: low 32 bits of the sample timestamp
// followed by payloadSz bytes of interleaved int16 I/Q. The device
// timestamp counter is 32-bit and wraps every 2^32 samples (~4.4 h at
// 270.833 kS/s); the host extends it to 64 bits by incrementing a hi32
// word whenever the low-32 value goes backwards
// (USRPDevice.cpp:358-363).
//
// Returns the number of data samples written into the ring. flags_out
// (if non-null) receives [0] = 1 if any packet carried the underrun
// flag, [1] = last RSSI field seen, [2] = number of non-data-channel
// packets skipped.

static const size_t kPktBytes = 512;

extern "C" int64_t ring_write_packets(sample_ring *r, const uint8_t *pkts,
                                      int64_t n_bytes, int32_t *flags_out) {
  if (!r || !pkts || n_bytes < (int64_t)kPktBytes) return 0;
  int32_t underrun = 0, rssi = 0, skipped = 0;
  int64_t written = 0;
  for (int64_t off = 0; off + (int64_t)kPktBytes <= n_bytes;
       off += kPktBytes) {
    const uint8_t *p = pkts + off;
    uint32_t word0, ts32;
    std::memcpy(&word0, p, 4);
    std::memcpy(&ts32, p + 4, 4);
    uint32_t chan = (word0 >> 16) & 0x1f;
    uint32_t payload_bytes = word0 & 0x1ff;
    if (payload_bytes > kPktBytes - 8) payload_bytes = kPktBytes - 8;

    // extension BEFORE the channel demux: the reference extends every
    // packet's timestamp (control replies included) so the hi32 state
    // follows the stream even across non-data packets
    int64_t ts64;
    {
      std::lock_guard<std::mutex> g(r->lock);
      if (r->last_pkt_ts >= 0 &&
          (uint32_t)(r->last_pkt_ts & 0xffffffffll) > ts32)
        r->hi32++;
      ts64 = ((int64_t)r->hi32 << 32) | (int64_t)ts32;
      r->last_pkt_ts = ts64;
    }

    if ((word0 >> 28) & 0x4) underrun = 1;  // Tx-chain underrun report
    if (chan != 0) {  // control reply / other channel: not sample data
      skipped++;
      continue;
    }
    rssi = (int32_t)((word0 >> 21) & 0x3f);
    int64_t n = (int64_t)(payload_bytes / 4);  // complex int16 samples
    if (n > 0)
      written += ring_write(r, (const int16_t *)(p + 8), n, ts64);
  }
  if (flags_out) {
    flags_out[0] = underrun;
    flags_out[1] = rssi;
    flags_out[2] = skipped;
  }
  return written;
}

extern "C" int64_t ring_last_pkt_ts(const sample_ring *r) {
  return r ? r->last_pkt_ts : -1;
}
