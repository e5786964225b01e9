// Native host runtime of the M17 framework (the PyTorch port's own copy).
//
// Replaces the reference's host-side concurrency plumbing with modern
// lock-free equivalents (cf. buffers.cpp: one mutex around a free pool
// + bounded FIFO; m17_net.cpp: blocking UDP thread):
//
//   * SPSC ring buffer for sample blocks between IO threads and the
//     device feed thread (radio -> pipeline boundary,
//     radio_receive_samples contract: 48 kHz int16 IQ blocks).
//   * Bounded MPSC datagram queue: the reflector jitter buffer
//     (54-byte frames, 200 cap -- buffers.cpp:11).
//   * UDP socket + background receive thread for the M17 reflector
//     protocol (port 17000), pushing datagrams into the queue.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>
#include <thread>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// SPSC ring buffer of fixed-size blocks
// ---------------------------------------------------------------------------
struct Ring {
    uint8_t *data;
    size_t block_bytes;
    size_t capacity;            // number of blocks, power of two
    std::atomic<uint64_t> head; // write index (producer)
    std::atomic<uint64_t> tail; // read index (consumer)
};

Ring *ring_create(size_t block_bytes, size_t capacity_pow2) {
    // a large-batch ring can ask for GBs; a failed allocation must
    // come back as nullptr through the C ABI, not a bad_alloc thrown
    // across the ctypes boundary (which aborts the process)
    try {
        Ring *r = new Ring();
        r->block_bytes = block_bytes;
        r->capacity = capacity_pow2;
        try {
            r->data = new uint8_t[block_bytes * capacity_pow2];
        } catch (const std::bad_alloc &) {
            delete r;
            return nullptr;
        }
        r->head.store(0);
        r->tail.store(0);
        return r;
    } catch (const std::bad_alloc &) {
        return nullptr;
    }
}

void ring_destroy(Ring *r) {
    if (!r) return;
    delete[] r->data;
    delete r;
}

// returns 1 on success, 0 if full
int ring_push(Ring *r, const uint8_t *block) {
    uint64_t head = r->head.load(std::memory_order_relaxed);
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    if (head - tail >= r->capacity) return 0;
    std::memcpy(r->data + (head % r->capacity) * r->block_bytes, block,
                r->block_bytes);
    r->head.store(head + 1, std::memory_order_release);
    return 1;
}

// returns 1 on success, 0 if empty
int ring_pop(Ring *r, uint8_t *out) {
    uint64_t tail = r->tail.load(std::memory_order_relaxed);
    uint64_t head = r->head.load(std::memory_order_acquire);
    if (tail == head) return 0;
    std::memcpy(out, r->data + (tail % r->capacity) * r->block_bytes,
                r->block_bytes);
    r->tail.store(tail + 1, std::memory_order_release);
    return 1;
}

size_t ring_size(Ring *r) {
    return (size_t)(r->head.load(std::memory_order_acquire) -
                    r->tail.load(std::memory_order_acquire));
}

// ---------------------------------------------------------------------------
// Bounded MPSC datagram queue (mutex-free fast path via ticketed slots)
// ---------------------------------------------------------------------------
struct DgramQueue {
    static constexpr size_t MAX_DGRAM = 65536;  // fits a Pluto-rate 15360-sample int16 IQ block (61440 B) and everything smaller (48 kHz 7680 B blocks, 54 B reflector voice datagrams)
    uint8_t *data;
    uint16_t *lens;
    std::atomic<uint8_t> *ready;
    size_t capacity;
    std::atomic<uint64_t> head;
    std::atomic<uint64_t> tail;
};

DgramQueue *dq_create(size_t capacity) {
    DgramQueue *q = new DgramQueue();
    q->capacity = capacity;
    q->data = new uint8_t[capacity * DgramQueue::MAX_DGRAM];
    q->lens = new uint16_t[capacity];
    q->ready = new std::atomic<uint8_t>[capacity];
    for (size_t i = 0; i < capacity; i++) q->ready[i].store(0);
    q->head.store(0);
    q->tail.store(0);
    return q;
}

void dq_destroy(DgramQueue *q) {
    if (!q) return;
    delete[] q->data;
    delete[] q->lens;
    delete[] q->ready;
    delete q;
}

int dq_push(DgramQueue *q, const uint8_t *buf, uint16_t len) {
    if (len > DgramQueue::MAX_DGRAM) return 0;
    uint64_t head = q->head.load(std::memory_order_relaxed);
    for (;;) {
        uint64_t tail = q->tail.load(std::memory_order_acquire);
        if (head - tail >= q->capacity) return 0;  // full (jitter cap)
        if (q->head.compare_exchange_weak(head, head + 1,
                                          std::memory_order_acq_rel))
            break;
    }
    size_t slot = head % q->capacity;
    std::memcpy(q->data + slot * DgramQueue::MAX_DGRAM, buf, len);
    q->lens[slot] = len;
    q->ready[slot].store(1, std::memory_order_release);
    return 1;
}

int dq_pop(DgramQueue *q, uint8_t *out, uint16_t *len_out) {
    uint64_t tail = q->tail.load(std::memory_order_relaxed);
    uint64_t head = q->head.load(std::memory_order_acquire);
    if (tail == head) return 0;
    size_t slot = tail % q->capacity;
    if (!q->ready[slot].load(std::memory_order_acquire)) return 0;
    *len_out = q->lens[slot];
    std::memcpy(out, q->data + slot * DgramQueue::MAX_DGRAM, *len_out);
    q->ready[slot].store(0, std::memory_order_release);
    q->tail.store(tail + 1, std::memory_order_release);
    return 1;
}

size_t dq_size(DgramQueue *q) {
    return (size_t)(q->head.load(std::memory_order_acquire) -
                    q->tail.load(std::memory_order_acquire));
}

// ---------------------------------------------------------------------------
// UDP transport + receive thread (m17_net.cpp:169-313 equivalent)
// ---------------------------------------------------------------------------
struct UdpClient {
    int sock;
    struct sockaddr_in peer;
    DgramQueue *rx_queue;
    std::thread rx_thread;
    std::atomic<bool> running;
};

UdpClient *udp_create(const char *peer_ip, uint16_t peer_port,
                      uint16_t bind_port, size_t queue_cap) {
    UdpClient *u = new UdpClient();
    u->sock = socket(AF_INET, SOCK_DGRAM, IPPROTO_UDP);
    if (u->sock < 0) { delete u; return nullptr; }
    int reuse = 1;
    setsockopt(u->sock, SOL_SOCKET, SO_REUSEADDR, &reuse, sizeof(reuse));
    // bind_port 0 binds a free port the kernel picks (udp_local_port
    // reads it back), so a receiver needs no fixed, machine-wide port
    struct sockaddr_in me;
    std::memset(&me, 0, sizeof(me));
    me.sin_family = AF_INET;
    me.sin_addr.s_addr = htonl(INADDR_ANY);
    me.sin_port = htons(bind_port);
    if (bind(u->sock, (struct sockaddr *)&me, sizeof(me)) < 0) {
        close(u->sock);
        delete u;
        return nullptr;
    }
    std::memset(&u->peer, 0, sizeof(u->peer));
    u->peer.sin_family = AF_INET;
    // inet_addr returns INADDR_NONE (the broadcast address) for
    // anything that is not a dotted quad -- a DNS hostname must fail
    // loudly here, not silently sendto() 255.255.255.255 forever
    // (the Python wrapper resolves hostnames before this call)
    u->peer.sin_addr.s_addr = inet_addr(peer_ip);
    if (u->peer.sin_addr.s_addr == INADDR_NONE &&
        std::strcmp(peer_ip, "255.255.255.255") != 0) {
        close(u->sock);
        delete u;
        return nullptr;
    }
    u->peer.sin_port = htons(peer_port);
    u->rx_queue = dq_create(queue_cap);
    u->running.store(false);
    return u;
}

int udp_send_to_peer(UdpClient *u, const uint8_t *buf, int len) {
    return (int)sendto(u->sock, buf, len, 0, (struct sockaddr *)&u->peer,
                       sizeof(u->peer));
}

static void udp_rx_loop(UdpClient *u) {
    uint8_t buf[DgramQueue::MAX_DGRAM];
    struct timeval tv;
    tv.tv_sec = 0;
    tv.tv_usec = 100000;  // 100 ms poll so stop() is responsive
    setsockopt(u->sock, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    while (u->running.load(std::memory_order_acquire)) {
        ssize_t n = recvfrom(u->sock, buf, sizeof(buf), 0, nullptr, nullptr);
        if (n > 0) dq_push(u->rx_queue, buf, (uint16_t)n);
    }
}

void udp_start_rx(UdpClient *u) {
    if (u->running.load()) return;
    u->running.store(true);
    u->rx_thread = std::thread(udp_rx_loop, u);
}

int udp_poll(UdpClient *u, uint8_t *out, uint16_t *len_out) {
    return dq_pop(u->rx_queue, out, len_out);
}

size_t udp_queue_size(UdpClient *u) { return dq_size(u->rx_queue); }

uint16_t udp_local_port(UdpClient *u) {
    struct sockaddr_in me;
    socklen_t len = sizeof(me);
    if (getsockname(u->sock, (struct sockaddr *)&me, &len) < 0) return 0;
    return ntohs(me.sin_port);
}

void udp_destroy(UdpClient *u) {
    if (!u) return;
    if (u->running.load()) {
        u->running.store(false);
        if (u->rx_thread.joinable()) u->rx_thread.join();
    }
    close(u->sock);
    dq_destroy(u->rx_queue);
    delete u;
}

}  // extern "C"
