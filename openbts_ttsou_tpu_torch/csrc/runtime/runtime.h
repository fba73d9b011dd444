// Native runtime for the TPU transceiver: UDP datagram transport (the
// three planes: data / control / clock) and a timestamped sample ring
// buffer. C ABI for ctypes.
//
// Reference behavior: CommonLibs/Sockets.{h,cpp} (UDPSocket) and
// Transceiver52M/USRPDevice.{h,cpp} (2^21-sample timestamped ring buffer
// with 32->64-bit timestamp extension).
#pragma once
#include <cstdint>
#include <cstddef>

extern "C" {

// ---- UDP datagram transport (UDPSocket, Sockets.h:128) ----------------
// Returns a handle (>=0) or -1 on error.
int udt_open(int local_port, const char *remote_host, int remote_port);
int udt_open_unix(const char *local_path, const char *remote_path);
// Send to the configured remote. Returns bytes sent or -1.
int udt_send(int h, const void *buf, int len);
// Blocking receive with timeout_ms (-1 = forever). Returns bytes, 0 on
// timeout, -1 on error.
int udt_recv(int h, void *buf, int maxlen, int timeout_ms);
// Send n_pkts back-to-back fixed-size packets -> packets sent.
int udt_send_batch(int h, const uint8_t *pkts, int n_pkts, int pkt_len);
// Non-blocking drain of pkt_len-sized datagrams into out -> count.
int udt_drain_fixed(int h, int pkt_len, int max_pkts, uint8_t *out);
void udt_close(int h);

// ---- timestamped complex-int16 sample ring (USRPDevice.h:68-88) -------
// Samples are interleaved int16 I/Q pairs. Timestamps are in samples.
typedef struct sample_ring sample_ring;
sample_ring *ring_create(size_t capacity_samples);
void ring_destroy(sample_ring *r);
// Write n samples tagged with starting timestamp ts (must be
// monotonically contiguous or a gap is zero-filled up to capacity).
// Returns samples accepted.
int64_t ring_write(sample_ring *r, const int16_t *iq, int64_t n, int64_t ts);
// Read n samples starting at timestamp ts into out. Blocks nothing;
// returns the number of valid samples copied (the rest zero-filled),
// or -1 if ts is entirely in the future/past beyond capacity.
int64_t ring_read(sample_ring *r, int16_t *iq_out, int64_t n, int64_t ts);
// Highest timestamp written + 1 (i.e., next expected), -1 if empty.
int64_t ring_end_ts(const sample_ring *r);
int64_t ring_start_ts(const sample_ring *r);

// ---- transmit burst priority queue (VectorQueue,
//      Transceiver52M/radioInterface.cpp:30-73) --------------------------
typedef struct burst_pq burst_pq;
burst_pq *bpq_create(size_t max_bursts);
void bpq_destroy(burst_pq *p);
// Queue a burst for (fn, chan, tn); latest write wins. -1 when full.
int bpq_push(burst_pq *p, int64_t fn, int chan, int tn,
             const uint8_t *data, int len);
// Pop the exact (fn, chan, tn) burst -> its length, 0 if absent.
int bpq_pop_exact(burst_pq *p, int64_t fn, int chan, int tn,
                  uint8_t *out, int maxlen);
// Drop bursts scheduled before fn (modular hyperframe time) -> count.
int bpq_dump_stale(burst_pq *p, int64_t fn);
int bpq_size(const burst_pq *p);
int64_t bpq_min_fn(const burst_pq *p, int64_t ref);
// Bulk-ingest 154-byte downlink datagrams for one carrier -> queued;
// *n_late counts bursts already past tx_fn (underrun signal).
int bpq_push_block(burst_pq *p, int chan, const uint8_t *pkts, int n_pkts,
                   int64_t tx_fn, int32_t *n_late);
// Pop bursts in [fn0, fn0+frames) into dense [frames][n_chan][8] arrays.
int bpq_pop_block(burst_pq *p, int64_t fn0, int frames, int n_chan,
                  uint8_t *bits, uint8_t *valid, float *gain);
}
