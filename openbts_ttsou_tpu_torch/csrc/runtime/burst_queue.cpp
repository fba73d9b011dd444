// Transmit burst priority queue ordered by GSM time.
// Mirrors the reference's VectorQueue (Transceiver52M/radioInterface.cpp:
// 30-73): bursts sorted by (FN, TN) with modular hyperframe comparison,
// getStaleBurst (pop anything scheduled before a deadline) and
// getCurrentBurst (pop an exact (FN, TN) match), plus the
// InterthreadPriorityQueue locking discipline (CommonLibs/Interthread.h:453).
#include "runtime.h"

#include <cstring>
#include <map>
#include <mutex>
#include <vector>

namespace {
constexpr int64_t kHyper = 2715648;  // GSM hyperframe (GSMCommon.h:306)

// Modular signed distance a-b in frames, in (-kHyper/2, kHyper/2].
inline int64_t fn_delta(int64_t a, int64_t b) {
  int64_t d = (a - b) % kHyper;
  if (d < 0) d += kHyper;
  if (d > kHyper / 2) d -= kHyper;
  return d;
}

struct Key {
  int64_t fn;
  int chan;
  int tn;
  bool operator<(const Key &o) const {
    if (fn != o.fn) return fn < o.fn;
    if (chan != o.chan) return chan < o.chan;
    return tn < o.tn;
  }
};
}  // namespace

struct burst_pq {
  std::map<Key, std::vector<uint8_t>> q;
  size_t max_bursts = 0;
  std::mutex lock;
};

extern "C" burst_pq *bpq_create(size_t max_bursts) {
  auto *p = new burst_pq;
  p->max_bursts = max_bursts ? max_bursts : SIZE_MAX;
  return p;
}

extern "C" void bpq_destroy(burst_pq *p) { delete p; }

extern "C" int bpq_push(burst_pq *p, int64_t fn, int chan, int tn,
                        const uint8_t *data, int len) {
  if (!p || len < 0) return -1;
  std::lock_guard<std::mutex> g(p->lock);
  if (p->q.size() >= p->max_bursts) return -1;
  Key k{((fn % kHyper) + kHyper) % kHyper, chan, tn};
  p->q[k].assign(data, data + len);  // latest write wins (filler refresh)
  return 0;
}

// Pop the burst scheduled exactly at (fn, chan, tn); returns its length,
// 0 if absent (getCurrentBurst).
extern "C" int bpq_pop_exact(burst_pq *p, int64_t fn, int chan, int tn,
                             uint8_t *out, int maxlen) {
  if (!p) return 0;
  std::lock_guard<std::mutex> g(p->lock);
  Key k{((fn % kHyper) + kHyper) % kHyper, chan, tn};
  auto it = p->q.find(k);
  if (it == p->q.end()) return 0;
  int n = (int)it->second.size();
  if (n > maxlen) n = maxlen;
  std::memcpy(out, it->second.data(), n);
  p->q.erase(it);
  return n;
}

// Drop every burst scheduled before `fn` in modular time; returns the
// number dropped (getStaleBurst's drain).
extern "C" int bpq_dump_stale(burst_pq *p, int64_t fn) {
  if (!p) return 0;
  std::lock_guard<std::mutex> g(p->lock);
  int dropped = 0;
  for (auto it = p->q.begin(); it != p->q.end();) {
    if (fn_delta(it->first.fn, fn) < 0) {
      it = p->q.erase(it);
      ++dropped;
    } else {
      ++it;
    }
  }
  return dropped;
}

// Bulk-ingest raw 154-byte downlink datagrams [TN|FN:4 BE|gain|148
// bit-bytes] (driveTransmitPriorityQueue wire format,
// Transceiver52M/Transceiver.cpp:571-630) for one carrier. Packets
// whose FN is already past tx_fn count as late (the underrun signal
// driving the adaptive clock lead, Transceiver.cpp:688-716). Returns
// packets queued; *n_late gets the late count.
extern "C" int bpq_push_block(burst_pq *p, int chan, const uint8_t *pkts,
                              int n_pkts, int64_t tx_fn,
                              int32_t *n_late) {
  if (!p) return 0;
  constexpr int kPkt = 154;
  int pushed = 0, late = 0;
  std::lock_guard<std::mutex> g(p->lock);
  for (int i = 0; i < n_pkts; i++) {
    const uint8_t *d = pkts + (size_t)i * kPkt;
    int tn = d[0] & 7;
    int64_t fn = ((int64_t)d[1] << 24) | ((int64_t)d[2] << 16) |
                 ((int64_t)d[3] << 8) | (int64_t)d[4];
    fn = ((fn % kHyper) + kHyper) % kHyper;
    if (fn_delta(fn, tx_fn) < 0) ++late;
    if (p->q.size() >= p->max_bursts) continue;
    // payload stored as [gain f32][148 bit-bytes] like bpq_push users
    std::vector<uint8_t> v(4 + 148);
    float gain = (float)d[5];
    std::memcpy(v.data(), &gain, 4);
    std::memcpy(v.data() + 4, d + 6, 148);
    p->q[Key{fn, chan, tn}] = std::move(v);
    ++pushed;
  }
  if (n_late) *n_late = late;
  return pushed;
}

// Pop every burst scheduled in [fn0, fn0+frames) into dense
// frame-major arrays for the block modulator (the 13-frame window of
// models/transceiver.py): bits [frames][n_chan][8][148] (uint8),
// valid [frames][n_chan][8] (uint8), gain [frames][n_chan][8] (f32).
// Slots without a burst keep valid=0 (the filler-table fallback,
// Transceiver.cpp:165-175). Returns bursts popped.
extern "C" int bpq_pop_block(burst_pq *p, int64_t fn0, int frames,
                             int n_chan, uint8_t *bits, uint8_t *valid,
                             float *gain) {
  if (!p || frames <= 0 || n_chan <= 0) return 0;
  std::lock_guard<std::mutex> g(p->lock);
  int popped = 0;
  for (auto it = p->q.begin(); it != p->q.end();) {
    int64_t d = fn_delta(it->first.fn, fn0);
    if (d < 0 || d >= frames || it->first.chan >= n_chan ||
        it->second.size() != 4 + 148) {
      ++it;
      continue;
    }
    size_t slot = ((size_t)d * n_chan + it->first.chan) * 8 + it->first.tn;
    std::memcpy(&gain[slot], it->second.data(), 4);
    for (int b = 0; b < 148; b++)
      bits[slot * 148 + b] = it->second[4 + b] & 1;
    valid[slot] = 1;
    ++popped;
    it = p->q.erase(it);
  }
  return popped;
}

extern "C" int bpq_size(const burst_pq *p) {
  if (!p) return 0;
  std::lock_guard<std::mutex> g(const_cast<burst_pq *>(p)->lock);
  return (int)p->q.size();
}

// Earliest scheduled FN relative to `ref` (modular), or -1 when empty.
extern "C" int64_t bpq_min_fn(const burst_pq *p, int64_t ref) {
  if (!p) return -1;
  std::lock_guard<std::mutex> g(const_cast<burst_pq *>(p)->lock);
  if (p->q.empty()) return -1;
  int64_t best = -1;
  int64_t best_d = 0;
  for (const auto &kv : p->q) {
    int64_t d = fn_delta(kv.first.fn, ref);
    if (best < 0 || d < best_d) {
      best = kv.first.fn;
      best_d = d;
    }
  }
  return best;
}
