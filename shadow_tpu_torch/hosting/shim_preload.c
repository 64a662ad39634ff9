/* LD_PRELOAD shim: run an unmodified network binary under the
 * simulator.
 *
 * The minimal realization of the reference's interposition library
 * (the reference Shadow's src/preload/shd-interposer.c: 262 PRELOADDEF
 * wrappers dispatching to process_emu_* or the real libc): this shim
 * interposes the socket/epoll/poll/select/clock/sleep/entropy surface
 * a typical network client or server uses and forwards each call as a
 * fixed-size request over the socketpair inherited in SHADOW_SHIM_FD;
 * the simulator-side peer is shadow_tpu_torch/hosting/shim.py (protocol
 * defined there).
 *
 * Virtual fd numbering: a virtual fd IS a real fd number —
 * each simulated socket/epoll/random-device reserves a kernel fd by
 * opening /dev/null and the simulator keys its state by that number.
 * This keeps vfds small and dense (select()'s fd_set caps fds at
 * FD_SETSIZE=1024, and real apps assume small fds), guarantees no
 * collision with the process's real fds (the kernel can't hand the
 * number out twice), and gives close() ordinary semantics (placeholder
 * and simulator state retire together). The reference solves the same
 * problem with a shadow descriptor table layered over the process fd
 * space (shd-host.c fd mapping).
 *
 * Virtualized beyond sockets (reference shd-process.c
 * equivalents in parens):
 *  - poll/ppoll/select/pselect on virtual fds (process_emu_poll/
 *    select, shd-process.c:2606-2899);
 *  - gettimeofday/time/clock_gettime all read SIMULATED time
 *    (shd-process.c:4329-4389 — one leaking wallclock call breaks
 *    determinism);
 *  - nanosleep/usleep/sleep advance SIM time, not wall time
 *    (process_emu_nanosleep, shd-process.c:3055);
 *  - getrandom/getentropy and open("/dev/u?random") serve bytes from
 *    the host's deterministic PRNG (shd-host.c:574; determinism test
 *    src/test/determinism/shd-test-determinism.c:15-60);
 *  - getsockname/getpeername answer the real simulated identity;
 *  - pthread_create fails LOUDLY (EAGAIN + stderr): a silently-real
 *    thread would corrupt sim semantics — multi-threaded hosting
 *    (the reference's rpth + pthread emu, shd-process.c:5074-7449)
 *    is not implemented.
 *
 * Payload note: the engine models byte COUNTS, but real
 * payload bytes ride the control channel host-side: send() ships the
 * app's buffer to the simulator, which stores it per connection
 * (api.PayloadBroker) and returns the true stream contents with each
 * recv() when BOTH endpoints are hosted processes. recv() from a
 * MODELED peer zero-fills; UDP datagram payloads are not materialized.
 *
 * Blocking semantics: each vfd tracks O_NONBLOCK (fcntl /
 * SOCK_NONBLOCK at creation). Nonblocking fds keep EINPROGRESS/EAGAIN
 * returns; BLOCKING connect/recv/recvfrom/accept/poll/epoll_wait
 * forward a block flag and the simulator parks the call until the
 * matching wake (shim.py _maybe_unpark) — the analogue of the
 * reference's rpth green-thread block/reenter (shd-process.c:
 * 1076-1263).
 */
#define _GNU_SOURCE
#include <dlfcn.h>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <poll.h>
#include <pthread.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/ioctl.h>
#include <sys/random.h>
#include <sys/select.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <time.h>
#include <unistd.h>

#define FD_CAP (1 << 16)

/* per-fd state bits (vfds are real fd numbers < FD_CAP in practice;
 * an fd past the cap simply cannot become virtual) */
#define VS_VFD 1      /* simulator-managed fd */
#define VS_NB 2       /* O_NONBLOCK */
#define VS_DGRAM 4    /* SOCK_DGRAM: sends never attach payload */
#define VS_RANDOM 8   /* /dev/u?random: reads serve host PRNG bytes */
static unsigned char vstate[FD_CAP];

static int is_vfd(int fd) {
    return fd >= 0 && fd < FD_CAP && (vstate[fd] & VS_VFD);
}

static int vfd_nb(int fd) { return is_vfd(fd) && (vstate[fd] & VS_NB); }

static void vfd_set_nb(int fd, int on) {
    if (fd >= 0 && fd < FD_CAP) {
        if (on) vstate[fd] |= VS_NB; else vstate[fd] &= ~VS_NB;
    }
}

static int vfd_dg(int fd) { return is_vfd(fd) && (vstate[fd] & VS_DGRAM); }

enum {
    OP_SOCKET = 1, OP_CONNECT, OP_SEND, OP_RECV, OP_CLOSE, OP_SHUTDOWN,
    OP_EPOLL_CREATE, OP_EPOLL_CTL, OP_EPOLL_WAIT, OP_CLOCK, OP_RESOLVE,
    OP_BIND, OP_LISTEN, OP_ACCEPT, OP_SENDTO, OP_RECVFROM,
    OP_SLEEP, OP_POLL, OP_RANDOM, OP_GETNAME, OP_VIOLATION,
};

struct req { int32_t op; int32_t a; int64_t b; int64_t c; char name[64]; };
struct rsp { int64_t r0; int64_t r1; int64_t r2; };
/* OP_EPOLL_WAIT / OP_POLL responses with r0 = n > 0 are followed by n
 * of these (fd, events/revents pairs; see shim.py _rsp_events) */
struct evpair { int64_t fd; int64_t events; };

static int chan_fd = -1;
static ssize_t (*real_send)(int, const void *, size_t, int);
static ssize_t (*real_recv)(int, void *, size_t, int);
static ssize_t (*real_read)(int, void *, size_t);
static ssize_t (*real_write)(int, const void *, size_t);
static int (*real_close)(int);
static int (*real_socket)(int, int, int);
static int (*real_connect)(int, const struct sockaddr *, socklen_t);
static int (*real_shutdown)(int, int);
static int (*real_epoll_create1)(int);
static int (*real_epoll_ctl)(int, int, int, struct epoll_event *);
static int (*real_epoll_wait)(int, struct epoll_event *, int, int);
static int (*real_clock_gettime)(clockid_t, struct timespec *);
static int (*real_getaddrinfo)(const char *, const char *,
                               const struct addrinfo *,
                               struct addrinfo **);
static int (*real_poll)(struct pollfd *, nfds_t, int);
static int (*real_open)(const char *, int, ...);

static void shim_init(void) {
    static int done = 0;
    if (done) return;
    done = 1;
    real_send = dlsym(RTLD_NEXT, "send");
    real_recv = dlsym(RTLD_NEXT, "recv");
    real_read = dlsym(RTLD_NEXT, "read");
    real_write = dlsym(RTLD_NEXT, "write");
    real_close = dlsym(RTLD_NEXT, "close");
    real_socket = dlsym(RTLD_NEXT, "socket");
    real_connect = dlsym(RTLD_NEXT, "connect");
    real_shutdown = dlsym(RTLD_NEXT, "shutdown");
    real_epoll_create1 = dlsym(RTLD_NEXT, "epoll_create1");
    real_epoll_ctl = dlsym(RTLD_NEXT, "epoll_ctl");
    real_epoll_wait = dlsym(RTLD_NEXT, "epoll_wait");
    real_clock_gettime = dlsym(RTLD_NEXT, "clock_gettime");
    real_getaddrinfo = dlsym(RTLD_NEXT, "getaddrinfo");
    real_poll = dlsym(RTLD_NEXT, "poll");
    real_open = dlsym(RTLD_NEXT, "open");
    const char *env = getenv("SHADOW_SHIM_FD");
    if (env) chan_fd = atoi(env);
}

static int active(void) {
    shim_init();
    return chan_fd >= 0;
}

/* Reserve a kernel fd number for a new virtual fd. The placeholder
 * (an open /dev/null) pins the number so no real open can collide
 * with it; the simulator keys its state by this number. Returns -1
 * (EMFILE/ENFILE errno from open) on failure. */
static int vfd_reserve(void) {
    int fd = real_open("/dev/null", O_RDWR | O_CLOEXEC);
    if (fd < 0) return -1;
    if (fd >= FD_CAP) {   /* cannot track state past the table */
        real_close(fd);
        errno = EMFILE;
        return -1;
    }
    vstate[fd] = VS_VFD;
    return fd;
}

static void vfd_release(int fd) {
    if (fd >= 0 && fd < FD_CAP) {
        vstate[fd] = 0;
        real_close(fd);
    }
}

/* one lockstep request/response on the control channel.
 *
 * Payload framing: OP_SEND requests on STREAM sockets are followed by
 * exactly b payload bytes (the app's REAL buffer); OP_POLL requests
 * are followed by a * 16 bytes of evpairs (the virtual pollfd set).
 * Datagram OP_SEND and OP_SENDTO attach nothing. Successful OP_RECV /
 * OP_RANDOM responses with r1 == 1 are followed by exactly r0 payload
 * bytes; r1 == 0 means no live stream covers the read (modeled peer)
 * and the CALLER zero-fills locally. OP_RECVFROM responses never carry
 * payload (r1/r2 hold the datagram source). tx/txn attach request
 * payload; rx/rxcap receive response payload. A short read/write kills
 * the channel (EPIPE) rather than desynchronize the framing. */
static struct rsp call2(int32_t op, int32_t a, int64_t b, int64_t c,
                        const char *name, const void *tx, size_t txn,
                        void *rx, size_t rxcap) {
    struct req q;
    struct rsp r = {-1, 0, 0};
    memset(&q, 0, sizeof q);
    q.op = op; q.a = a; q.b = b; q.c = c;
    if (name) strncpy(q.name, name, sizeof q.name - 1);
    size_t off = 0;
    while (off < sizeof q) {
        ssize_t n = real_write(chan_fd, (char *)&q + off, sizeof q - off);
        if (n <= 0) { chan_fd = -1; errno = EPIPE; return r; }
        off += (size_t)n;
    }
    off = 0;
    while (off < txn) {
        ssize_t n = real_write(chan_fd, (const char *)tx + off, txn - off);
        if (n <= 0) { chan_fd = -1; errno = EPIPE; return r; }
        off += (size_t)n;
    }
    off = 0;
    while (off < sizeof r) {
        ssize_t n = real_read(chan_fd, (char *)&r + off, sizeof r - off);
        if (n <= 0) {
            chan_fd = -1; errno = EPIPE;
            struct rsp bad = {-1, 0, 0}; return bad;
        }
        off += (size_t)n;
    }
    if (rx && r.r0 > 0 && r.r1 == 1) {
        if ((size_t)r.r0 > rxcap) {   /* protocol violation: the sim
            * side answered more than we asked — unrecoverable framing */
            chan_fd = -1; errno = EPIPE;
            struct rsp bad = {-1, 0, 0}; return bad;
        }
        off = 0;
        while (off < (size_t)r.r0) {
            ssize_t n = real_read(chan_fd, (char *)rx + off,
                                  (size_t)r.r0 - off);
            if (n <= 0) {
                chan_fd = -1; errno = EPIPE;
                struct rsp bad = {-1, 0, 0}; return bad;
            }
            off += (size_t)n;
        }
    }
    return r;
}

static struct rsp call(int32_t op, int32_t a, int64_t b, int64_t c,
                       const char *name) {
    return call2(op, a, b, c, name, NULL, 0, NULL, 0);
}

/* --- interposed surface ------------------------------------------------ */

int socket(int domain, int type, int protocol) {
    if (!active() || domain != AF_INET)
        return real_socket(domain, type, protocol);
    int dgram = (type & 0xFF) == SOCK_DGRAM;
    int fd = vfd_reserve();
    if (fd < 0) return -1;
    struct rsp r = call(OP_SOCKET, dgram, fd, 0, NULL);
    if (r.r0 < 0) { vfd_release(fd); errno = EMFILE; return -1; }
    if (type & SOCK_NONBLOCK) vstate[fd] |= VS_NB;
    if (dgram) vstate[fd] |= VS_DGRAM;
    return fd;
}

int bind(int fd, const struct sockaddr *addr, socklen_t len) {
    if (!active() || !is_vfd(fd)) {
        static int (*real_bind)(int, const struct sockaddr *, socklen_t);
        if (!real_bind) real_bind = dlsym(RTLD_NEXT, "bind");
        return real_bind(fd, addr, len);
    }
    const struct sockaddr_in *a = (const struct sockaddr_in *)addr;
    struct rsp r = call(OP_BIND, fd, ntohs(a->sin_port), 0, NULL);
    if (r.r0 < 0) { errno = (int)r.r1; return -1; }
    return 0;
}

int listen(int fd, int backlog) {
    if (!active() || !is_vfd(fd)) {
        static int (*real_listen)(int, int);
        if (!real_listen) real_listen = dlsym(RTLD_NEXT, "listen");
        return real_listen(fd, backlog);
    }
    struct rsp r = call(OP_LISTEN, fd, backlog, 0, NULL);
    if (r.r0 < 0) { errno = (int)r.r1; return -1; }
    return 0;
}

int accept4(int fd, struct sockaddr *addr, socklen_t *len, int flags) {
    if (!active() || !is_vfd(fd)) {
        static int (*real_accept4)(int, struct sockaddr *, socklen_t *,
                                   int);
        if (!real_accept4) real_accept4 = dlsym(RTLD_NEXT, "accept4");
        return real_accept4(fd, addr, len, flags);
    }
    int cfd = vfd_reserve();   /* the child's number, picked up front */
    if (cfd < 0) return -1;
    struct rsp r = call(OP_ACCEPT, fd, vfd_nb(fd) ? 0 : 1, cfd, NULL);
    if (r.r0 < 0) { vfd_release(cfd); errno = (int)r.r1; return -1; }
    if (flags & SOCK_NONBLOCK) vstate[cfd] |= VS_NB;
    if (addr && len && *len >= sizeof(struct sockaddr_in)) {
        struct sockaddr_in *a = (struct sockaddr_in *)addr;
        memset(a, 0, sizeof *a);
        a->sin_family = AF_INET;
        a->sin_addr.s_addr = (uint32_t)r.r1;  /* virtual peer host id */
        a->sin_port = htons((uint16_t)r.r2);
        *len = sizeof *a;
    }
    return cfd;
}

int accept(int fd, struct sockaddr *addr, socklen_t *len) {
    if (!active() || !is_vfd(fd)) {
        static int (*real_accept)(int, struct sockaddr *, socklen_t *);
        if (!real_accept) real_accept = dlsym(RTLD_NEXT, "accept");
        return real_accept(fd, addr, len);
    }
    return accept4(fd, addr, len, 0);
}

ssize_t sendto(int fd, const void *buf, size_t n, int flags,
               const struct sockaddr *addr, socklen_t alen) {
    if (!active() || !is_vfd(fd)) {
        static ssize_t (*real_sendto)(int, const void *, size_t, int,
                                      const struct sockaddr *, socklen_t);
        if (!real_sendto) real_sendto = dlsym(RTLD_NEXT, "sendto");
        return real_sendto(fd, buf, n, flags, addr, alen);
    }
    if (!addr) return send(fd, buf, n, flags);
    const struct sockaddr_in *a = (const struct sockaddr_in *)addr;
    int64_t packed = ((int64_t)a->sin_addr.s_addr << 16) |
                     (int64_t)ntohs(a->sin_port);
    /* OP_SENDTO never attaches payload: datagram contents are not
     * materialized, so there is nothing for the simulator to keep */
    struct rsp r = call(OP_SENDTO, fd, (int64_t)n, packed, NULL);
    if (r.r0 < 0) { errno = (int)r.r1; return -1; }
    return (ssize_t)r.r0;
}

ssize_t recvfrom(int fd, void *buf, size_t n, int flags,
                 struct sockaddr *addr, socklen_t *alen) {
    if (!active() || !is_vfd(fd)) {
        static ssize_t (*real_recvfrom)(int, void *, size_t, int,
                                        struct sockaddr *, socklen_t *);
        if (!real_recvfrom) real_recvfrom = dlsym(RTLD_NEXT, "recvfrom");
        return real_recvfrom(fd, buf, n, flags, addr, alen);
    }
    int blk = !vfd_nb(fd) && !(flags & MSG_DONTWAIT);
    struct rsp r = call(OP_RECVFROM, fd, (int64_t)n, blk, NULL);
    if (r.r0 < 0) { errno = (int)r.r1; return -1; }
    if ((size_t)r.r0 > n) {  /* protocol violation: never overrun buf */
        chan_fd = -1; errno = EPIPE; return -1;
    }
    memset(buf, 0, (size_t)r.r0);  /* datagram payloads not materialized */
    if (addr && alen && *alen >= sizeof(struct sockaddr_in)) {
        struct sockaddr_in *a = (struct sockaddr_in *)addr;
        memset(a, 0, sizeof *a);
        a->sin_family = AF_INET;
        a->sin_addr.s_addr = (uint32_t)r.r1;  /* virtual src host id */
        a->sin_port = htons((uint16_t)r.r2);
        *alen = sizeof *a;
    }
    return (ssize_t)r.r0;
}

int connect(int fd, const struct sockaddr *addr, socklen_t len) {
    if (!active() || !is_vfd(fd)) return real_connect(fd, addr, len);
    const struct sockaddr_in *a = (const struct sockaddr_in *)addr;
    /* sin_addr carries the virtual host id verbatim (stamped by our
     * getaddrinfo); sin_port is network order. Bit 16 of the port
     * word = blocking call: park until established. */
    int64_t port = ntohs(a->sin_port);
    if (!vfd_nb(fd)) port |= (int64_t)1 << 16;
    struct rsp r = call(OP_CONNECT, fd, (int64_t)a->sin_addr.s_addr,
                        port, NULL);
    if (r.r0 < 0) { errno = (int)r.r1; return -1; }
    return 0;
}

ssize_t send(int fd, const void *buf, size_t n, int flags) {
    if (!active() || !is_vfd(fd)) return real_send(fd, buf, n, flags);
    if (vstate[fd] & VS_RANDOM) {   /* write() to /dev/u?random (app
        * entropy seeding) — not a socket: forwarding OP_SEND would
        * make shim.py's handler KeyError on an fd it never tracked
        * and kill the whole simulation. Refuse like the recv() guard. */
        errno = EBADF;
        return -1;
    }
    /* stream sends carry the REAL payload: hosted<->hosted TCP
     * connections deliver true bytes (api.PayloadBroker). Datagram
     * sends attach nothing — UDP contents are not materialized. */
    if (vfd_dg(fd))
        return (ssize_t)call(OP_SEND, fd, (int64_t)n, 0, NULL).r0;
    return (ssize_t)call2(OP_SEND, fd, (int64_t)n, 1, NULL,
                          buf, n, NULL, 0).r0;
}

ssize_t recv(int fd, void *buf, size_t n, int flags) {
    if (!active() || !is_vfd(fd)) return real_recv(fd, buf, n, flags);
    if (vstate[fd] & VS_RANDOM) {       /* via recv on a random vfd */
        errno = ENOTSOCK; return -1;
    }
    int blk = !vfd_nb(fd) && !(flags & MSG_DONTWAIT);
    /* r1 == 1: the response carries the true stream contents (hosted
     * peer); r1 == 0: modeled peer, zero-fill locally */
    struct rsp r = call2(OP_RECV, fd, (int64_t)n, blk, NULL,
                         NULL, 0, buf, n);
    if (r.r0 < 0) { errno = (int)r.r1; return -1; }
    if ((size_t)r.r0 > n) {  /* protocol violation: never overrun buf */
        chan_fd = -1; errno = EPIPE; return -1;
    }
    if (r.r1 != 1) memset(buf, 0, (size_t)r.r0);
    return (ssize_t)r.r0;
}

/* serve n deterministic PRNG bytes from the simulator (chunked so one
 * huge read cannot wedge the channel) */
static ssize_t random_fill(void *buf, size_t n) {
    size_t got = 0;
    while (got < n) {
        size_t k = n - got;
        if (k > (1 << 16)) k = 1 << 16;
        struct rsp r = call2(OP_RANDOM, 0, (int64_t)k, 0, NULL,
                             NULL, 0, (char *)buf + got, k);
        if (r.r0 <= 0) return got ? (ssize_t)got : -1;
        got += (size_t)r.r0;
    }
    return (ssize_t)got;
}

ssize_t write(int fd, const void *buf, size_t n) {
    if (active() && is_vfd(fd)) return send(fd, buf, n, 0);
    shim_init();
    return real_write(fd, buf, n);
}

ssize_t read(int fd, void *buf, size_t n) {
    if (active() && is_vfd(fd)) {
        if (vstate[fd] & VS_RANDOM) return random_fill(buf, n);
        return recv(fd, buf, n, 0);
    }
    shim_init();
    return real_read(fd, buf, n);
}

int shutdown(int fd, int how) {
    if (!active() || !is_vfd(fd)) return real_shutdown(fd, how);
    return (int)call(OP_SHUTDOWN, fd, how, 0, NULL).r0;
}

int close(int fd) {
    if (!active() || !is_vfd(fd)) { shim_init(); return real_close(fd); }
    int rnd = vstate[fd] & VS_RANDOM;
    int rc = rnd ? 0 : (int)call(OP_CLOSE, fd, 0, 0, NULL).r0;
    vfd_release(fd);        /* free the placeholder + state bits */
    return rc;
}

int epoll_create1(int flags) {
    if (!active()) return real_epoll_create1(flags);
    int fd = vfd_reserve();
    if (fd < 0) return -1;
    struct rsp r = call(OP_EPOLL_CREATE, 0, fd, 0, NULL);
    if (r.r0 < 0) { vfd_release(fd); errno = EMFILE; return -1; }
    return fd;
}

int epoll_create(int size) { (void)size; return epoll_create1(0); }

int epoll_ctl(int epfd, int op, int fd, struct epoll_event *ev) {
    if (!active() || !is_vfd(epfd)) return real_epoll_ctl(epfd, op, fd, ev);
    int64_t packed = (int64_t)op |
        ((int64_t)(ev ? ev->events : 0) << 32);
    return (int)call(OP_EPOLL_CTL, epfd, packed, fd, NULL).r0;
}

/* read n trailing evpairs of a wait/poll response into out[] (cap
 * entries); returns n or -1 on channel failure */
static int read_evpairs(int n, struct evpair *out, int cap) {
    for (int i = 0; i < n; i++) {
        struct evpair p;
        size_t off = 0;
        while (off < sizeof p) {
            ssize_t m = real_read(chan_fd, (char *)&p + off,
                                  sizeof p - off);
            if (m <= 0) {
                /* short read of a trailing evpair: returning a partial
                 * count would leave unread bytes in the channel and
                 * the next call() would parse them as a rsp header —
                 * a silent protocol desync. Kill the channel and fail
                 * fast instead. */
                chan_fd = -1;
                errno = EPIPE;
                return -1;
            }
            off += (size_t)m;
        }
        if (i < cap) out[i] = p;
    }
    return n;
}

int epoll_wait(int epfd, struct epoll_event *evs, int maxevents,
               int timeout) {
    if (!active() || !is_vfd(epfd))
        return real_epoll_wait(epfd, evs, maxevents, timeout);
    if (maxevents < 1) { errno = EINVAL; return -1; }
    struct rsp r = call(OP_EPOLL_WAIT, epfd, timeout, maxevents, NULL);
    if (r.r0 <= 0) return (int)r.r0;
    /* r0 = n <= maxevents ready events (the sim honors maxevents);
     * read the n trailing (fd, events) pairs straight into evs */
    int n = (int)r.r0;
    if (n > maxevents) { chan_fd = -1; errno = EPIPE; return -1; }
    for (int i = 0; i < n; i++) {
        struct evpair p;
        if (read_evpairs(1, &p, 1) < 0) return -1;
        evs[i].events = (uint32_t)p.events;
        evs[i].data.fd = (int)p.fd;
    }
    return n;
}

int epoll_pwait(int epfd, struct epoll_event *evs, int maxevents,
                int timeout, const sigset_t *mask) {
    (void)mask;   /* no signals are delivered to parked hosted code */
    if (!active() || !is_vfd(epfd)) {
        static int (*real_ep)(int, struct epoll_event *, int, int,
                              const sigset_t *);
        if (!real_ep) real_ep = dlsym(RTLD_NEXT, "epoll_pwait");
        return real_ep(epfd, evs, maxevents, timeout, mask);
    }
    return epoll_wait(epfd, evs, maxevents, timeout);
}

/* --- poll / select ----------------------------------------------------- */

static int vsleep_ns(int64_t ns);   /* defined with the sleep surface */

/* Forward the VIRTUAL subset of a pollfd array to the simulator.
 * Mixed sets (virtual + real fds) wait only on the virtual ones —
 * real fds report no events (documented limitation: the simulator
 * cannot wait on kernel fds, and hosted binaries' interesting fds are
 * exactly the virtual ones). Returns the poll() result over fds[]. */
static int vpoll(struct pollfd *fds, nfds_t nfds, int timeout_ms) {
    struct evpair want[256];
    int nv = 0, nreal = 0;
    nfds_t nvirt = 0;
    for (nfds_t i = 0; i < nfds; i++) {
        fds[i].revents = 0;   /* ALL entries, unconditionally: a stale
            * revents on an entry past any cap would report phantom
            * readiness */
        if (fds[i].fd < 0) continue;   /* negative fd = ignore entry */
        if (is_vfd(fds[i].fd)) {
            nvirt++;
            if (nv < 256) {
                want[nv].fd = fds[i].fd;
                want[nv].events = fds[i].events;
                nv++;
            }
        } else {
            nreal++;
        }
    }
    if (nvirt > 256) {   /* fail LOUD instead of silently waiting on a
        * truncated subset (events on the dropped fds would never
        * wake the caller) */
        errno = EINVAL;
        return -1;
    }
    if (nv == 0) {
        /* a poll that waits on NOTHING (empty array, or every entry
         * disabled with fd < 0 — both standard sleep idioms) must
         * advance SIM time: a real poll would burn wallclock while
         * the virtual clock stays frozen, so `while (time() <
         * deadline) poll(0,0,100)` would never terminate (this
         * mirrors nanosleep -> OP_SLEEP). The infinite form
         * (timeout -1, the pause() idiom) must not reach the REAL
         * poll either — it would block the child forever in wallclock
         * and wedge the whole simulator (shim.py waits in _read_req);
         * park it past any stop_time instead (the run's teardown
         * releases the child). */
        if (nreal == 0 && timeout_ms != 0) {
            vsleep_ns(timeout_ms > 0 ? (int64_t)timeout_ms * 1000000LL
                                     : (int64_t)1 << 62);
            return 0;
        }
        return real_poll(fds, nfds, timeout_ms);
    }
    struct rsp r = call2(OP_POLL, nv, (int64_t)nv * sizeof(struct evpair),
                         timeout_ms, NULL, want,
                         (size_t)nv * sizeof(struct evpair), NULL, 0);
    if (r.r0 < 0) { errno = (int)r.r1 ? (int)r.r1 : EPIPE; return -1; }
    int n = (int)r.r0;
    struct evpair pairs[256];
    if (n > 256) { chan_fd = -1; errno = EPIPE; return -1; }
    if (n > 0 && read_evpairs(n, pairs, 256) < 0) return -1;
    int hits = 0;
    for (nfds_t i = 0; i < nfds; i++) {
        for (int j = 0; j < n; j++) {
            if (pairs[j].fd == fds[i].fd) {
                fds[i].revents = (short)pairs[j].events;
                break;
            }
        }
        if (fds[i].revents) hits++;
    }
    return hits;
}

int poll(struct pollfd *fds, nfds_t nfds, int timeout) {
    if (!active()) { shim_init(); return real_poll(fds, nfds, timeout); }
    return vpoll(fds, nfds, timeout);
}

int ppoll(struct pollfd *fds, nfds_t nfds, const struct timespec *ts,
          const sigset_t *mask) {
    (void)mask;
    if (!active()) {
        static int (*real_pp)(struct pollfd *, nfds_t,
                              const struct timespec *, const sigset_t *);
        if (!real_pp) real_pp = dlsym(RTLD_NEXT, "ppoll");
        return real_pp(fds, nfds, ts, mask);
    }
    int ms = ts ? (int)(ts->tv_sec * 1000 +
                        (ts->tv_nsec + 999999) / 1000000) : -1;
    return vpoll(fds, nfds, ms);
}

/* select() rebuilt on vpoll: only meaningful for fds < FD_SETSIZE —
 * which all vfds are, because a vfd IS a small real fd number */
static int vselect(int nfds, fd_set *rs, fd_set *ws, fd_set *es,
                   int timeout_ms) {
    struct pollfd pfds[FD_SETSIZE];
    int np = 0;
    for (int fd = 0; fd < nfds && fd < FD_SETSIZE; fd++) {
        short ev = 0;
        if (rs && FD_ISSET(fd, rs)) ev |= POLLIN;
        if (ws && FD_ISSET(fd, ws)) ev |= POLLOUT;
        if (es && FD_ISSET(fd, es)) ev |= POLLPRI;
        if (ev) { pfds[np].fd = fd; pfds[np].events = ev; np++; }
    }
    int rc = vpoll(pfds, np, timeout_ms);
    if (rc < 0) return -1;
    if (rs) FD_ZERO(rs);
    if (ws) FD_ZERO(ws);
    if (es) FD_ZERO(es);
    int bits = 0;
    for (int i = 0; i < np; i++) {
        short rev = pfds[i].revents;
        if (rs && (rev & (POLLIN | POLLHUP | POLLERR | POLLRDHUP))) {
            FD_SET(pfds[i].fd, rs); bits++;
        }
        if (ws && (rev & (POLLOUT | POLLERR))) {
            FD_SET(pfds[i].fd, ws); bits++;
        }
    }
    return bits;
}

static int fdset_has_vfd(int nfds, fd_set *s) {
    if (!s) return 0;
    for (int fd = 0; fd < nfds && fd < FD_SETSIZE; fd++)
        if (FD_ISSET(fd, s) && is_vfd(fd)) return 1;
    return 0;
}

static int fdset_any(int nfds, fd_set *s) {
    if (!s) return 0;
    for (int fd = 0; fd < nfds && fd < FD_SETSIZE; fd++)
        if (FD_ISSET(fd, s)) return 1;
    return 0;
}

int select(int nfds, fd_set *rs, fd_set *ws, fd_set *es,
           struct timeval *tv) {
    shim_init();
    static int (*real_select)(int, fd_set *, fd_set *, fd_set *,
                              struct timeval *);
    if (!real_select) real_select = dlsym(RTLD_NEXT, "select");
    if (!active() || (!fdset_has_vfd(nfds, rs) &&
                      !fdset_has_vfd(nfds, ws) &&
                      !fdset_has_vfd(nfds, es))) {
        /* empty-set select with a timeout is the classic portable
         * sleep — advance SIM time like poll(NULL,0,ms) above; a NULL
         * tv (block forever) parks past any stop_time rather than
         * wedging the simulator in the real syscall. "Empty" means NO
         * bit set in any of the three sets, whatever nfds claims. */
        if (active() && !fdset_any(nfds, rs) && !fdset_any(nfds, ws) &&
            !fdset_any(nfds, es)) {
            if (!tv) {
                vsleep_ns((int64_t)1 << 62);
                return 0;
            }
            if (tv->tv_sec > 0 || tv->tv_usec > 0) {
                vsleep_ns((int64_t)tv->tv_sec * 1000000000LL +
                          (int64_t)tv->tv_usec * 1000);
                /* Linux select() writes back the remaining time; a
                 * full elapse leaves zero (retry loops depend on it) */
                tv->tv_sec = 0;
                tv->tv_usec = 0;
                return 0;
            }
        }
        return real_select(nfds, rs, ws, es, tv);
    }
    int ms = tv ? (int)(tv->tv_sec * 1000 +
                        (tv->tv_usec + 999) / 1000) : -1;
    return vselect(nfds, rs, ws, es, ms);
}

int pselect(int nfds, fd_set *rs, fd_set *ws, fd_set *es,
            const struct timespec *ts, const sigset_t *mask) {
    (void)mask;
    shim_init();
    static int (*real_ps)(int, fd_set *, fd_set *, fd_set *,
                          const struct timespec *, const sigset_t *);
    if (!real_ps) real_ps = dlsym(RTLD_NEXT, "pselect");
    if (!active() || (!fdset_has_vfd(nfds, rs) &&
                      !fdset_has_vfd(nfds, ws) &&
                      !fdset_has_vfd(nfds, es))) {
        /* pselect's timeout is const (Linux never modifies it) */
        if (active() && !fdset_any(nfds, rs) && !fdset_any(nfds, ws) &&
            !fdset_any(nfds, es)) {
            if (!ts) {
                vsleep_ns((int64_t)1 << 62);
                return 0;
            }
            if (ts->tv_sec > 0 || ts->tv_nsec > 0) {
                vsleep_ns((int64_t)ts->tv_sec * 1000000000LL +
                          (int64_t)ts->tv_nsec);
                return 0;
            }
        }
        return real_ps(nfds, rs, ws, es, ts, mask);
    }
    int ms = ts ? (int)(ts->tv_sec * 1000 +
                        (ts->tv_nsec + 999999) / 1000000) : -1;
    return vselect(nfds, rs, ws, es, ms);
}

/* --- time, sleep, entropy ---------------------------------------------- */

int clock_gettime(clockid_t clk, struct timespec *ts) {
    if (!active()) return real_clock_gettime(clk, ts);
    int64_t ns = call(OP_CLOCK, (int32_t)clk, 0, 0, NULL).r0;
    ts->tv_sec = ns / 1000000000LL;
    ts->tv_nsec = ns % 1000000000LL;
    return 0;
}

int gettimeofday(struct timeval *tv, void *tz) {
    (void)tz;
    if (!active()) {
        static int (*real_gtod)(struct timeval *, void *);
        if (!real_gtod) real_gtod = dlsym(RTLD_NEXT, "gettimeofday");
        return real_gtod(tv, tz);
    }
    if (tv) {
        int64_t ns = call(OP_CLOCK, CLOCK_REALTIME, 0, 0, NULL).r0;
        tv->tv_sec = ns / 1000000000LL;
        tv->tv_usec = (ns % 1000000000LL) / 1000;
    }
    return 0;
}

time_t time(time_t *tloc) {
    if (!active()) {
        static time_t (*real_time)(time_t *);
        if (!real_time) real_time = dlsym(RTLD_NEXT, "time");
        return real_time(tloc);
    }
    time_t t = (time_t)(call(OP_CLOCK, CLOCK_REALTIME, 0, 0, NULL).r0 /
                        1000000000LL);
    if (tloc) *tloc = t;
    return t;
}

/* sleeping advances SIMULATED time: the call parks until a sim-time
 * timer fires (reference process_emu_nanosleep, shd-process.c:3055 —
 * a real sleep would burn wallclock while sim time is frozen) */
static int vsleep_ns(int64_t ns) {
    if (ns <= 0) return 0;
    struct rsp r = call(OP_SLEEP, 0, ns, 0, NULL);
    return (int)r.r0;
}

int nanosleep(const struct timespec *req, struct timespec *rem) {
    if (!active()) {
        static int (*real_ns)(const struct timespec *, struct timespec *);
        if (!real_ns) real_ns = dlsym(RTLD_NEXT, "nanosleep");
        return real_ns(req, rem);
    }
    if (!req || req->tv_sec < 0 || req->tv_nsec < 0 ||
        req->tv_nsec > 999999999L) {
        errno = EINVAL;
        return -1;
    }
    int rc = vsleep_ns(req->tv_sec * 1000000000LL + req->tv_nsec);
    if (rem) { rem->tv_sec = 0; rem->tv_nsec = 0; }
    return rc;
}

int clock_nanosleep(clockid_t clk, int flags, const struct timespec *req,
                    struct timespec *rem) {
    if (!active()) {
        static int (*real_cns)(clockid_t, int, const struct timespec *,
                               struct timespec *);
        if (!real_cns) real_cns = dlsym(RTLD_NEXT, "clock_nanosleep");
        return real_cns(clk, flags, req, rem);
    }
    if (flags & TIMER_ABSTIME) {
        struct timespec now;
        clock_gettime(clk, &now);
        int64_t d = (req->tv_sec - now.tv_sec) * 1000000000LL +
                    (req->tv_nsec - now.tv_nsec);
        vsleep_ns(d);
        return 0;
    }
    return nanosleep(req, rem) ? errno : 0;
}

int usleep(useconds_t us) {
    if (!active()) {
        static int (*real_us)(useconds_t);
        if (!real_us) real_us = dlsym(RTLD_NEXT, "usleep");
        return real_us(us);
    }
    return vsleep_ns((int64_t)us * 1000);
}

unsigned int sleep(unsigned int seconds) {
    if (!active()) {
        static unsigned int (*real_sleep)(unsigned int);
        if (!real_sleep) real_sleep = dlsym(RTLD_NEXT, "sleep");
        return real_sleep(seconds);
    }
    vsleep_ns((int64_t)seconds * 1000000000LL);
    return 0;
}

/* entropy from the host's deterministic PRNG (reference shd-host.c:574
 * random source; determinism dual-run test shd-test-determinism.c) */
ssize_t getrandom(void *buf, size_t n, unsigned int flags) {
    (void)flags;
    if (!active()) {
        static ssize_t (*real_gr)(void *, size_t, unsigned int);
        if (!real_gr) real_gr = dlsym(RTLD_NEXT, "getrandom");
        if (real_gr) return real_gr(buf, n, flags);
        errno = ENOSYS;
        return -1;
    }
    return random_fill(buf, n);
}

int getentropy(void *buf, size_t n) {
    if (!active()) {
        static int (*real_ge)(void *, size_t);
        if (!real_ge) real_ge = dlsym(RTLD_NEXT, "getentropy");
        if (real_ge) return real_ge(buf, n);
        errno = ENOSYS;
        return -1;
    }
    if (n > 256) { errno = EIO; return -1; }
    return random_fill(buf, n) == (ssize_t)n ? 0 : -1;
}

static int is_random_path(const char *path) {
    return path && (!strcmp(path, "/dev/random") ||
                    !strcmp(path, "/dev/urandom") ||
                    !strcmp(path, "/dev/srandom"));
}

int open(const char *path, int flags, ...) {
    va_list ap;
    va_start(ap, flags);
    mode_t mode = va_arg(ap, mode_t);
    va_end(ap);
    shim_init();
    if (active() && is_random_path(path)) {
        int fd = vfd_reserve();
        if (fd >= 0) vstate[fd] |= VS_RANDOM;
        return fd;
    }
    return real_open(path, flags, mode);
}

int open64(const char *path, int flags, ...) {
    va_list ap;
    va_start(ap, flags);
    mode_t mode = va_arg(ap, mode_t);
    va_end(ap);
    shim_init();
    if (active() && is_random_path(path)) {
        int fd = vfd_reserve();
        if (fd >= 0) vstate[fd] |= VS_RANDOM;
        return fd;
    }
    static int (*real_open64)(const char *, int, ...);
    if (!real_open64) real_open64 = dlsym(RTLD_NEXT, "open64");
    return real_open64(path, flags, mode);
}

int openat(int dirfd, const char *path, int flags, ...) {
    va_list ap;
    va_start(ap, flags);
    mode_t mode = va_arg(ap, mode_t);
    va_end(ap);
    shim_init();
    if (active() && is_random_path(path)) {
        int fd = vfd_reserve();
        if (fd >= 0) vstate[fd] |= VS_RANDOM;
        return fd;
    }
    static int (*real_openat)(int, const char *, int, ...);
    if (!real_openat) real_openat = dlsym(RTLD_NEXT, "openat");
    return real_openat(dirfd, path, flags, mode);
}

/* --- fopen entropy: glibc's fopen calls an INTERNAL open,
 * so the open/open64/openat interposition above never sees
 * fopen("/dev/urandom") and the stream would read real kernel entropy
 * — breaking the determinism guarantee for stdio-based readers. Back
 * the stream with fopencookie over random_fill instead (the reference
 * interposes fopen/fopen64 for the same reason, shd-interposer.c). */

static ssize_t random_cookie_read(void *cookie, char *buf, size_t n) {
    (void)cookie;
    return random_fill(buf, n);
}

static FILE *random_stream(void) {
    cookie_io_functions_t io = {0};
    io.read = random_cookie_read;
    FILE *f = fopencookie(NULL, "r", io);
    /* unbuffered: stdio readahead would pull KBs per small fread,
     * consuming a different amount of the host PRNG stream than the
     * getrandom/open paths do for the same app behavior */
    if (f) setvbuf(f, NULL, _IONBF, 0);
    return f;
}

FILE *fopen(const char *path, const char *mode) {
    shim_init();
    static FILE *(*real_fopen)(const char *, const char *);
    if (!real_fopen) real_fopen = dlsym(RTLD_NEXT, "fopen");
    if (active() && is_random_path(path)) return random_stream();
    return real_fopen(path, mode);
}

FILE *fopen64(const char *path, const char *mode) {
    shim_init();
    static FILE *(*real_fopen64)(const char *, const char *);
    if (!real_fopen64) real_fopen64 = dlsym(RTLD_NEXT, "fopen64");
    if (active() && is_random_path(path)) return random_stream();
    return real_fopen64(path, mode);
}

/* --- process creation: REFUSED (reference shd-process.c:3195-3234).
 * A forked/exec'd child would share the control channel fd with no
 * protocol identity of its own, make raw libc calls outside the sim,
 * and escape the clock/entropy/network virtualization entirely — the
 * classic sandbox escape. Refuse LOUDLY: errno = ENOSYS, a stderr
 * diagnostic, and an OP_VIOLATION record so the simulator's exit
 * report names the attempt (hosting.shim). Only PLT calls interpose —
 * a static binary or an internal glibc clone bypasses this, like
 * every LD_PRELOAD scheme. */

static int refuse(const char *what) {
    shim_init();
    fprintf(stderr, "shadow-shim: %s refused — hosted processes "
            "cannot fork/exec inside the simulation\n", what);
    if (active()) call(OP_VIOLATION, 0, 0, 0, what);
    errno = ENOSYS;
    return -1;
}

pid_t fork(void) {
    if (!active()) {
        static pid_t (*real_fork)(void);
        if (!real_fork) real_fork = dlsym(RTLD_NEXT, "fork");
        return real_fork();
    }
    return (pid_t)refuse("fork");
}

pid_t vfork(void) {
    if (!active()) {
        static pid_t (*real_vfork)(void);
        if (!real_vfork) real_vfork = dlsym(RTLD_NEXT, "vfork");
        return real_vfork();
    }
    return (pid_t)refuse("vfork");
}

int execve(const char *p, char *const a[], char *const e[]) {
    if (!active()) {
        static int (*real_ev)(const char *, char *const[],
                              char *const[]);
        if (!real_ev) real_ev = dlsym(RTLD_NEXT, "execve");
        return real_ev(p, a, e);
    }
    return refuse("execve");
}

int execv(const char *p, char *const a[]) {
    if (!active()) {
        static int (*real_v)(const char *, char *const[]);
        if (!real_v) real_v = dlsym(RTLD_NEXT, "execv");
        return real_v(p, a);
    }
    return refuse("execv");
}

int execvp(const char *p, char *const a[]) {
    if (!active()) {
        static int (*real_vp)(const char *, char *const[]);
        if (!real_vp) real_vp = dlsym(RTLD_NEXT, "execvp");
        return real_vp(p, a);
    }
    return refuse("execvp");
}

int execvpe(const char *p, char *const a[], char *const e[]) {
    if (!active()) {
        static int (*real_vpe)(const char *, char *const[],
                               char *const[]);
        if (!real_vpe) real_vpe = dlsym(RTLD_NEXT, "execvpe");
        return real_vpe(p, a, e);
    }
    return refuse("execvpe");
}

int fexecve(int fd, char *const a[], char *const e[]) {
    if (!active()) {
        static int (*real_fe)(int, char *const[], char *const[]);
        if (!real_fe) real_fe = dlsym(RTLD_NEXT, "fexecve");
        return real_fe(fd, a, e);
    }
    return refuse("fexecve");
}

/* variadic execl family: a faithful passthrough would need to rebuild
 * the argv — refuse unconditionally under the sim, and rebuild is
 * unnecessary outside it because the shim only loads via the
 * simulator's LD_PRELOAD (active() is the only supported state). */
int execl(const char *p, const char *arg, ...) {
    (void)p; (void)arg;
    return refuse("execl");
}

int execlp(const char *p, const char *arg, ...) {
    (void)p; (void)arg;
    return refuse("execlp");
}

int execle(const char *p, const char *arg, ...) {
    (void)p; (void)arg;
    return refuse("execle");
}

int posix_spawn(pid_t *pid, const char *path, const void *fa,
                const void *attr, char *const argv[],
                char *const envp[]) {
    if (!active()) {
        static int (*real_ps)(pid_t *, const char *, const void *,
                              const void *, char *const[],
                              char *const[]);
        if (!real_ps) real_ps = dlsym(RTLD_NEXT, "posix_spawn");
        return real_ps(pid, path, fa, attr, argv, envp);
    }
    refuse("posix_spawn");
    return ENOSYS;   /* posix_spawn returns the errno, not -1 */
}

int posix_spawnp(pid_t *pid, const char *file, const void *fa,
                 const void *attr, char *const argv[],
                 char *const envp[]) {
    if (!active()) {
        static int (*real_psp)(pid_t *, const char *, const void *,
                               const void *, char *const[],
                               char *const[]);
        if (!real_psp) real_psp = dlsym(RTLD_NEXT, "posix_spawnp");
        return real_psp(pid, file, fa, attr, argv, envp);
    }
    refuse("posix_spawnp");
    return ENOSYS;
}

int system(const char *cmd) {
    if (!active()) {
        static int (*real_system)(const char *);
        if (!real_system) real_system = dlsym(RTLD_NEXT, "system");
        return real_system(cmd);
    }
    if (!cmd) return 0;   /* POSIX: NULL asks "is a shell available" */
    return refuse("system");
}

FILE *popen(const char *cmd, const char *mode) {
    if (!active()) {
        static FILE *(*real_popen)(const char *, const char *);
        if (!real_popen) real_popen = dlsym(RTLD_NEXT, "popen");
        return real_popen(cmd, mode);
    }
    refuse("popen");
    return NULL;
}

/* --- threads: fail LOUDLY until multi-threaded hosting exists ---------- */

int pthread_create(pthread_t *thread, const pthread_attr_t *attr,
                   void *(*start)(void *), void *arg) {
    shim_init();
    if (!active()) {
        static int (*real_pc)(pthread_t *, const pthread_attr_t *,
                              void *(*)(void *), void *);
        if (!real_pc) real_pc = dlsym(RTLD_NEXT, "pthread_create");
        return real_pc(thread, attr, start, arg);
    }
    (void)thread; (void)attr; (void)start; (void)arg;
    /* A silently-real thread would make raw libc calls outside the
     * lockstep channel protocol and corrupt sim semantics — refuse
     * visibly instead (the reference runs threads as rpth green
     * threads, shd-process.c:5074-7449; not implemented here). */
    fprintf(stderr, "shadow-shim: pthread_create refused — "
            "multi-threaded hosted processes are not supported\n");
    return EAGAIN;
}

/* --- name service & identity ------------------------------------------- */

int getaddrinfo(const char *node, const char *service,
                const struct addrinfo *hints, struct addrinfo **res) {
    if (!active()) return real_getaddrinfo(node, service, hints, res);
    struct rsp r = call(OP_RESOLVE, 0, 0, 0, node);
    if (r.r0 < 0) return EAI_NONAME;
    struct addrinfo *ai = calloc(1, sizeof *ai);
    struct sockaddr_in *sa = calloc(1, sizeof *sa);
    sa->sin_family = AF_INET;
    sa->sin_addr.s_addr = (uint32_t)r.r0;   /* virtual host id */
    sa->sin_port = service ? htons((uint16_t)atoi(service)) : 0;
    ai->ai_family = AF_INET;
    ai->ai_socktype = hints ? hints->ai_socktype : SOCK_STREAM;
    ai->ai_addrlen = sizeof *sa;
    ai->ai_addr = (struct sockaddr *)sa;
    *res = ai;
    return 0;
}

void freeaddrinfo(struct addrinfo *res) {
    /* frees only what our getaddrinfo allocated; pass through others */
    if (!active()) {
        void (*real_fai)(struct addrinfo *) =
            dlsym(RTLD_NEXT, "freeaddrinfo");
        real_fai(res);
        return;
    }
    if (res) { free(res->ai_addr); free(res); }
}

/* the real simulated identity: servers
 * that bind port 0 / learn their port via getsockname, and apps that
 * key peers by getpeername, see true virtual addresses */
static int vgetname(int fd, struct sockaddr *addr, socklen_t *len,
                    int which) {
    struct rsp r = call(OP_GETNAME, fd, which, 0, NULL);
    if (r.r0 < 0) { errno = (int)r.r1 ? (int)r.r1 : ENOTCONN; return -1; }
    if (addr && len && *len >= sizeof(struct sockaddr_in)) {
        struct sockaddr_in *a = (struct sockaddr_in *)addr;
        memset(a, 0, sizeof *a);
        a->sin_family = AF_INET;
        a->sin_addr.s_addr = (uint32_t)r.r1;
        a->sin_port = htons((uint16_t)r.r2);
        *len = sizeof *a;
    }
    return 0;
}

int getsockname(int fd, struct sockaddr *addr, socklen_t *len) {
    if (!active() || !is_vfd(fd)) {
        static int (*real_gsn)(int, struct sockaddr *, socklen_t *);
        if (!real_gsn) real_gsn = dlsym(RTLD_NEXT, "getsockname");
        return real_gsn(fd, addr, len);
    }
    return vgetname(fd, addr, len, 0);
}

int getpeername(int fd, struct sockaddr *addr, socklen_t *len) {
    if (!active() || !is_vfd(fd)) {
        static int (*real_gpn)(int, struct sockaddr *, socklen_t *);
        if (!real_gpn) real_gpn = dlsym(RTLD_NEXT, "getpeername");
        return real_gpn(fd, addr, len);
    }
    return vgetname(fd, addr, len, 1);
}

/* harmless accepted no-ops on virtual fds */
int setsockopt(int fd, int level, int optname, const void *optval,
               socklen_t optlen) {
    if (active() && is_vfd(fd)) return 0;
    static int (*real_sso)(int, int, int, const void *, socklen_t);
    if (!real_sso) real_sso = dlsym(RTLD_NEXT, "setsockopt");
    return real_sso(fd, level, optname, optval, optlen);
}

int getsockopt(int fd, int level, int optname, void *optval,
               socklen_t *optlen) {
    if (active() && is_vfd(fd)) {
        /* SO_ERROR after EPOLLOUT: connection is established */
        if (optval && optlen && *optlen >= sizeof(int))
            *(int *)optval = 0;
        return 0;
    }
    static int (*real_gso)(int, int, int, void *, socklen_t *);
    if (!real_gso) real_gso = dlsym(RTLD_NEXT, "getsockopt");
    return real_gso(fd, level, optname, optval, optlen);
}

int ioctl(int fd, unsigned long req, ...) {
    __builtin_va_list ap;
    __builtin_va_start(ap, req);
    void *argp = __builtin_va_arg(ap, void *);
    __builtin_va_end(ap);
    if (active() && is_vfd(fd)) {
        /* FIONBIO is how CPython's internal_setblocking toggles
         * blocking mode on Linux — without this, s.setblocking(False)
         * or any socket timeout in a hosted python script would hit
         * the real kernel with a virtual fd's placeholder */
        if (req == FIONBIO && argp) {
            vfd_set_nb(fd, *(int *)argp != 0);
            return 0;
        }
        return 0;                       /* FIONREAD etc: accepted */
    }
    static int (*real_ioctl)(int, unsigned long, ...);
    if (!real_ioctl) real_ioctl = dlsym(RTLD_NEXT, "ioctl");
    return real_ioctl(fd, req, argp);
}

int fcntl(int fd, int cmd, ...) {
    __builtin_va_list ap;
    __builtin_va_start(ap, cmd);
    long arg = __builtin_va_arg(ap, long);
    __builtin_va_end(ap);
    if (active() && is_vfd(fd)) {
        if (cmd == F_SETFL) { vfd_set_nb(fd, arg & O_NONBLOCK); return 0; }
        if (cmd == F_GETFL) return vfd_nb(fd) ? O_NONBLOCK : 0;
        return 0;                        /* F_SETFD etc: accepted */
    }
    static int (*real_fcntl)(int, int, ...);
    if (!real_fcntl) real_fcntl = dlsym(RTLD_NEXT, "fcntl");
    return real_fcntl(fd, cmd, arg);
}
