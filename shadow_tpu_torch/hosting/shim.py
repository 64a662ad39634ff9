"""Unmodified-binary hosting: the LD_PRELOAD shim bridge.

The reference's defining trick is running real, unmodified binaries by
interposing 262 libc symbols (the reference Shadow's src/preload/
shd-interposer.c:211-222, shd-preload-defs.h) and re-entering blocked
app code with green threads (shd-process.c:1076-1263). This module is
the port's realization of that capability, a copy of
``shadow_tpu/hosting/shim.py`` with the port's obs modules:

- the REAL binary runs as a separate OS process with
  ``libshadow_shim.so`` LD_PRELOADed (hosting/shim_preload.c);
- the shim interposes the socket/epoll/poll/select/clock/sleep/entropy
  libc surface and forwards each call over an inherited socketpair to
  :class:`ShimApp`, a hosted app (hosting.api) inside the simulator;
- blocking semantics replace rpth: the binary only ever blocks inside
  a forwarded wait (epoll_wait/poll/select, blocking connect/recv/
  accept, nanosleep); the simulator answers it when a device wake
  (connection established, bytes delivered, EOF, timer) maps to it —
  so simulated time never advances while app code runs, exactly the
  reference's cooperative model;
- ALL clocks read simulated time (clock_gettime, gettimeofday,
  time — reference shd-process.c:4329-4389), sleeps advance sim time
  (process_emu_nanosleep, shd-process.c:3055), and entropy
  (getrandom/getentropy//dev/u?random) comes from the host's
  deterministic PRNG (shd-host.c:574) — a hosted binary that draws
  randomness runs bit-identically across runs (the reference's
  determinism dual-run, shd-test-determinism.c:15-60, realized in
  tests/test_shim_libc.py);
- TCP payload bytes are MATERIALIZED host-side: the engine
  models byte counts and timing, while the real bytes ride the control
  channel into a per-connection FIFO (api.PayloadBroker) keyed by the
  TCP 4-tuple both endpoints derive from their establishment wakes.
  A hosted endpoint talking to a MODELED app sees zero-fill, and UDP
  datagram payloads are not materialized.

Virtual fd numbering: the C side reserves a real kernel fd
(an open /dev/null placeholder) per virtual fd and the simulator keys
its state by that number — vfds stay small (select()'s fd_set caps
fds at 1024), never collide with the process's real fds, and close()
retires both together. Creating ops carry the reserved number.

Scenario usage: plugin="hosted:shim" with arguments
``[out=<stdout file>] cmd=<binary> [child args...]`` — cmd paths
resolve like any exec (absolute, or relative to the process CWD). The
preload library builds on demand with cc into the port's build
directory (hosting.build.build_dir, hosting.shim.build_shim).

Protocol (one request, one response, in lockstep — the child is
single-threaded between waits):
  request  = <iiqq64s>  op, a, b, c, name  (88 bytes)
  response = <qqq>      r0, r1, r2         (24 bytes)
  OP_EPOLL_WAIT / OP_POLL responses with r0 = n > 0 carry n trailing
  <qq> (fd, events) pairs. OP_POLL requests carry b trailing payload
  bytes (the virtual pollfd set as <qq> pairs). OP_SEND requests with
  c == 1 carry b trailing payload bytes (stream sends; datagram sends
  set c = 0 and attach nothing). Successful OP_RECV / OP_RANDOM
  responses with r1 == 1 carry r0 trailing payload bytes (real stream
  contents / PRNG bytes — r1 == 0 on OP_RECV means no live stream
  covers the read and the C side zero-fills locally). OP_RECVFROM
  responses never carry payload.
"""

from __future__ import annotations

import hashlib as _hashlib
import os as _os
import struct
import subprocess
import time as _time

from .api import HostedApp, register
from .build import build_dir, compile_c
from ..obs import digest as _DG
from ..obs import metrics as _MT

REQ = struct.Struct("<iiqq64s")
RSP = struct.Struct("<qqq")
EVPAIR = struct.Struct("<qq")

OP_SOCKET = 1
OP_CONNECT = 2
OP_SEND = 3
OP_RECV = 4
OP_CLOSE = 5
OP_SHUTDOWN = 6
OP_EPOLL_CREATE = 7
OP_EPOLL_CTL = 8
OP_EPOLL_WAIT = 9
OP_CLOCK = 10
OP_RESOLVE = 11
OP_BIND = 12
OP_LISTEN = 13
OP_ACCEPT = 14
OP_SENDTO = 15
OP_RECVFROM = 16
OP_SLEEP = 17
OP_POLL = 18
OP_RANDOM = 19
OP_GETNAME = 20
OP_VIOLATION = 21   # child attempted a refused operation (fork/exec):
#                     name carries what; diagnostic only, answer is 0

# op code -> metric name (obs.metrics shim.op.* counters and
# shim.op_us.* latency histograms, recorded per served request)
OP_NAMES = {
    OP_SOCKET: "socket", OP_CONNECT: "connect", OP_SEND: "send",
    OP_RECV: "recv", OP_CLOSE: "close", OP_SHUTDOWN: "shutdown",
    OP_EPOLL_CREATE: "epoll_create", OP_EPOLL_CTL: "epoll_ctl",
    OP_EPOLL_WAIT: "epoll_wait", OP_CLOCK: "clock",
    OP_RESOLVE: "resolve", OP_BIND: "bind", OP_LISTEN: "listen",
    OP_ACCEPT: "accept", OP_SENDTO: "sendto", OP_RECVFROM: "recvfrom",
    OP_SLEEP: "sleep", OP_POLL: "poll", OP_RANDOM: "random",
    OP_GETNAME: "getname", OP_VIOLATION: "violation",
}

EPOLLIN = 0x001
EPOLLOUT = 0x004
EPOLLRDHUP = 0x2000
EPOLLHUP = 0x010
EINPROGRESS = 115
ENOTCONN = 107
EAGAIN = 11
ECONNREFUSED = 111

EPOLL_CTL_ADD = 1
EPOLL_CTL_DEL = 2
EPOLL_CTL_MOD = 3

# sim-time timer tags (ride an i32 packet word; sign bit must stay
# clear): bits 0-19 = fd/id operand, bits 20-22 = kind, bits 24-30 =
# park sequence. A stale timer can only false-match the CURRENT park if
# kind, operand AND a 128-window sequence all line up — acceptable odds
# vs. the wedge an unmatched timeout causes.
TK_EPOLL = 0    # epoll_wait timeout (operand = epfd)
TK_SLEEP = 1    # nanosleep/usleep/sleep deadline
TK_POLL = 2     # poll/select timeout
TK_GRACE = 3    # deferred payload-stream drop (operand = grace id)


def _tag(kind, operand, seq):
    return ((seq & 0x7F) << 24) | ((kind & 0x7) << 20) | (operand & 0xFFFFF)


_SRC = _os.path.dirname(_os.path.abspath(__file__))
SHIM_C = _os.path.join(_SRC, "shim_preload.c")

# sim-time grace before an unsubscribed out-direction payload stream is
# dropped at close: long enough for the peer's establishment wake (one
# path latency) to arrive and subscribe — a hosted server that writes
# and closes within its accept window (banner-then-close) must not lose
# its bytes (shim OP_CLOSE)
GRACE_NS = 30 * 10**9

# hung-child watchdog: WALL-clock ceiling on one channel read. The
# protocol is lockstep, so between our reads the child is either
# computing (bounded by its own work) or about to issue its next
# request; a child stuck in a busy loop or wedged in real libc makes
# no RPC progress and would otherwise freeze the whole simulator
# inside _read_req. SHADOW_SHIM_WATCHDOG_S overrides; 0 disables.
WATCHDOG_S_DEFAULT = 30.0


# first link of the per-child protocol-stream digest chain
SHIM_CHAIN_SEED = _hashlib.blake2b(
    b"shadow_tpu.shim.ops.v1", digest_size=8).hexdigest()


class ShimHang(Exception):
    """Watchdog: the child made no RPC progress within the deadline."""


class ShimProtocolError(Exception):
    """The channel carried something the protocol forbids (short read
    mid-frame, oversized trailing payload, ...) — unrecoverable
    framing; the supervisor kills the channel, not the simulator."""


def _status_cause(status):
    """OS exit status -> (cause string, clean?) for the exit report."""
    if status is not None and status < 0:
        import signal as _signal
        try:
            signame = _signal.Signals(-status).name
        except ValueError:
            signame = f"signal {-status}"
        return f"killed by {signame}", False
    return f"exited status={status}", status == 0


def build_shim(out_dir: str = None) -> str:
    """Compile the preload library (cached) -> .so path.

    Builds into `out_dir` or the port's build directory
    (hosting.build.build_dir: owner-only, never next to the target
    binary, never at a predictable path in the world-writable temp
    dir, where another local user could pre-plant a .so that would
    then be LD_PRELOADed into our child processes). A cached .so is
    reused only if we own it and it is not group/other-writable."""
    if out_dir is None:
        out_dir = build_dir()
    else:
        _os.makedirs(out_dir, mode=0o700, exist_ok=True)
    return compile_c(["cc", "-shared", "-fPIC", "-O2", SHIM_C, "-ldl",
                      "-lpthread", "-o"],
                     _os.path.join(out_dir, "libshadow_shim.so"), SHIM_C)


class _VSock:
    """Shim-side view of one virtual socket fd."""

    __slots__ = ("sock", "avail", "eof", "connected", "closed", "key",
                 "kind", "bound_port", "accept_q", "dgrams", "dgram_dst",
                 "conn", "is_client", "pending_tx")

    def __init__(self, kind="tcp"):
        self.sock = None        # hosting.api.Sock once connect issued
        self.avail = 0          # delivered-but-unread byte count
        self.eof = False
        self.connected = False
        self.closed = False
        self.key = None         # (slot, gen) once resolved
        self.kind = kind        # "tcp" | "udp" | "listen"
        self.bound_port = 0
        self.accept_q = []      # listener: (child Sock, src, sport, conn)
        self.dgrams = []        # udp: (src_host, sport, nbytes)
        self.dgram_dst = None   # udp: connect()ed default destination
        # TCP payload stream identity (api.PayloadBroker): the
        # canonical (cli_host, cli_port, srv_host, srv_port) both
        # endpoints derive, or None until the connection resolves
        self.conn = None
        self.is_client = False
        self.pending_tx = []    # payloads written before conn resolved


class ShimApp(HostedApp):
    """Hosts one real binary behind the LD_PRELOAD shim (module doc)."""

    def __init__(self, args: str):
        parts = args.split()
        i = next((j for j, p in enumerate(parts)
                  if p.startswith("cmd=")), None)
        if i is None:
            raise ValueError("hosted:shim needs cmd=<binary> argument")
        # shim options (out=...) precede cmd=; everything AFTER cmd= is
        # the child's argv verbatim
        kv = dict(p.split("=", 1) for p in parts[:i + 1] if "=" in p)
        self.argv = [kv["cmd"]] + parts[i + 1:]
        self.out_path = kv.get("out")   # child stdout -> file (tests)
        self.proc = None
        self.chan = None          # our end of the socketpair
        self.vfds = {}            # vfd -> _VSock (vfd = C-reserved fd)
        self.by_sock = {}         # id(Sock) -> vfd (pre-resolution)
        self.by_key = {}          # (slot, gen) -> vfd: wakes arriving
        # after os.close() carry a FRESH Sock object for the same
        # incarnation (HostOS retires closed handles), so identity
        # lookup alone would drop e.g. the post-shutdown EOF
        self.epolls = {}          # vepfd -> {vfd: events}
        # the child's one blocked call (it is single-threaded): None,
        # ("epoll", epfd, maxev), ("connect", vfd), ("recv", vfd, n),
        # ("recvd", vfd, n) [blocking recv() on udp],
        # ("recvfrom", vfd, n), ("accept", vfd, cfd), ("sleep",), or
        # ("poll", interest). Blocking calls park here until a wake
        # satisfies them (_maybe_unpark) — the shim's replacement for
        # the reference's rpth block/reenter (shd-process.c:1076-1263)
        self.parked = None
        self.park_seq = 0         # increments per park: stale-timeout guard
        self.exited = False
        self._started = False     # a child was spawned at least once
        # --- checkpoint/resume (docs/durability.md) ---
        # protocol-stream journal: ordered ("rx"/"tx", bytes) records
        # of everything that crossed the channel since THIS child
        # spawned. None = disabled; enable_journal() (checkpointed
        # runs) arms it. resume_replay() respawns the child and pumps
        # the journal back: the shim virtualizes time, entropy and
        # I/O, so a deterministic binary re-issues byte-identical
        # requests and lands parked in the same blocked call.
        self._journal = None
        self._replaying = False
        # --- supervision (per-host exit report; SimReport.hosted) ---
        self.exit_status = None   # OS exit status (negative = -signal)
        self.exit_cause = None    # human diagnosis ("hung: ...", ...)
        self.exit_sim_ns = None   # sim time the death was observed
        self.exit_clean = False   # True: status-0 exit / end-of-run
        self.violations = []      # refused ops the child attempted
        self.watchdog_s = float(
            _os.environ.get("SHADOW_SHIM_WATCHDOG_S",
                            str(WATCHDOG_S_DEFAULT)) or 0)
        # protocol-request stream digest (obs.digest): every frame the
        # child issued, in service order — pins a determinism
        # divergence to "the child behaved differently" vs "the engine
        # diverged". A rolling chain (not one hash object) so
        # checkpoints can carry it — hashlib midstates do not pickle.
        # Updated only while a digest recorder is installed.
        self._op_chain = SHIM_CHAIN_SEED
        self._payloads = None     # api.PayloadBroker (runtime attaches)
        self._opened = set()      # broker keys this app opened
        self._mysubs = set()      # the subset I subscribed (I read)
        self._grace = {}          # grace id -> stream key pending drop
        self._next_grace = 0

    def attach_payload_broker(self, broker):
        """HostingRuntime wires the per-simulation PayloadBroker in:
        hosted<->hosted TCP connections then carry REAL bytes (counts
        still modeled by the engine; hosted<->modeled stays zero-fill)."""
        self._payloads = broker

    # --- payload streams (api.PayloadBroker) ---
    def _open_streams(self, vs):
        """Open both directions at establishment (writer-side open
        included: the accept wake precedes the connected wake in sim
        time, so a server's first push must not find a missing stream)
        and SUBSCRIBE the inbound one — subscription marks the stream
        as having a real reader, which exempts it from the reader-less
        cap and preserves it across the writer's close. Then flush
        sends issued before the identity resolved."""
        if self._payloads is None or vs.conn is None:
            return
        for d in (0, 1):
            key = vs.conn + (d,)
            self._payloads.open(key)
            self._opened.add(key)
        inkey = vs.conn + (1 if vs.is_client else 0,)
        self._payloads.subscribe(inkey)
        self._mysubs.add(inkey)
        if vs.pending_tx:
            out = vs.conn + (0 if vs.is_client else 1,)
            for data in vs.pending_tx:
                self._payloads.push(out, data)
            vs.pending_tx = []

    def _tx_payload(self, vs, data):
        if (self._payloads is None or vs.kind != "tcp" or not data):
            return
        if vs.conn is None:            # optimistic pre-connect write
            vs.pending_tx.append(data)
            return
        self._payloads.push(vs.conn + (0 if vs.is_client else 1,), data)

    def _rx_payload(self, vs, k):
        """Exactly k real stream bytes for a recv answer, or None when
        no live stream backs the connection (peer modeled) — the C side
        then zero-fills locally instead of moving k zeros over the
        channel."""
        if (self._payloads is None or vs is None or vs.conn is None
                or vs.kind != "tcp"):
            return None
        return self._payloads.pop(vs.conn + (1 if vs.is_client else 0,),
                                  int(k))

    # --- child lifecycle ---
    def _spawn(self):
        import socket as pysock
        ours, theirs = pysock.socketpair()
        env = dict(_os.environ)
        env["LD_PRELOAD"] = build_shim()
        env["SHADOW_SHIM_FD"] = str(theirs.fileno())
        stdout = (open(self.out_path, "w") if self.out_path else None)
        self.proc = subprocess.Popen(self.argv, env=env,
                                     pass_fds=(theirs.fileno(),),
                                     stdout=stdout)
        if stdout is not None:
            stdout.close()
        theirs.close()
        self.chan = ours
        self._started = True
        # wall-clock RPC deadline (module doc above WATCHDOG_S_DEFAULT):
        # applies to every channel read AND write, so a child that
        # stops draining its end cannot wedge _rsp either
        if self.watchdog_s > 0:
            self.chan.settimeout(self.watchdog_s)

    def _jrec(self, d: str, data: bytes):
        """Journal one channel transfer (adjacent same-direction
        records coalesce, so the journal is bounded by traffic, not
        read granularity). Replay traffic is never re-journaled — the
        restored journal already holds those bytes."""
        if self._journal is None or self._replaying or not data:
            return
        if self._journal and self._journal[-1][0] == d:
            self._journal[-1][1] += data
        else:
            self._journal.append([d, bytearray(data)])

    def _recv(self, n):
        """One watchdog-supervised channel read."""
        import socket as pysock
        try:
            chunk = self.chan.recv(n)
        except pysock.timeout:
            raise ShimHang(
                f"no RPC progress within {self.watchdog_s:g}s wall"
                f" (pid {self.proc.pid if self.proc else '?'})")
        self._jrec("rx", chunk)
        return chunk

    def _send(self, data: bytes):
        """One journaled channel write (every response goes through
        here so resume replay can reproduce the exact byte stream)."""
        self.chan.sendall(data)
        self._jrec("tx", data)

    def _read_req(self):
        buf = b""
        while len(buf) < REQ.size:
            chunk = self._recv(REQ.size - len(buf))
            if not chunk:
                if buf:
                    # EOF inside a frame: the child died (or wrote
                    # garbage) mid-request — diagnose, don't desync
                    raise ShimProtocolError(
                        f"channel EOF mid-request "
                        f"({len(buf)}/{REQ.size} header bytes)")
                return None
            buf += chunk
        return REQ.unpack(buf)

    def _read_n(self, n):
        """n trailing payload bytes of an OP_SEND/OP_POLL request."""
        buf = bytearray()
        n = int(n)
        if n < 0 or n > (64 << 20):
            raise ShimProtocolError(
                f"request claims {n} trailing payload bytes")
        while len(buf) < n:
            chunk = self._recv(min(n - len(buf), 1 << 20))
            if not chunk:
                raise ShimProtocolError(
                    f"channel EOF mid-payload ({len(buf)}/{n} bytes)")
            buf += chunk
        return bytes(buf)

    def _rsp(self, r0=0, r1=0, r2=0):
        self._send(RSP.pack(int(r0), int(r1), int(r2)))

    def _rsp_data(self, k, data=None):
        """OP_RECV/OP_RANDOM answer: header then, when `data` is real
        bytes (r1 = 1), EXACTLY k trailing payload bytes. data=None
        means no live stream backs the connection — r1 = 0, no
        trailing bytes, and the C side zero-fills locally (keeps the
        hosted<->modeled hot path free of per-byte channel traffic)."""
        k = max(int(k), 0)
        if data is None:
            self._send(RSP.pack(k, 0, 0))
            return
        out = data[:k] + b"\0" * (k - len(data))
        self._send(RSP.pack(k, 1, 0) + out)

    # --- epoll/poll readiness ---
    def _events_of(self, vfd):
        vs = self.vfds.get(vfd)
        if vs is None:
            return 0
        ev = 0
        if vs.kind == "listen":
            if vs.accept_q:
                ev |= EPOLLIN
            return ev
        if vs.kind == "udp":
            if vs.dgrams:
                ev |= EPOLLIN
            ev |= EPOLLOUT          # modeled datagrams never block
            return ev
        if vs.avail > 0 or vs.eof:
            ev |= EPOLLIN | (EPOLLRDHUP if vs.eof else 0)
        if vs.connected:
            ev |= EPOLLOUT
        return ev

    def _ready(self, vepfd, maxevents=1):
        hits = []
        for vfd, interest in self.epolls.get(vepfd, {}).items():
            ev = self._events_of(vfd) & (interest | EPOLLRDHUP | EPOLLHUP)
            if ev:
                hits.append((vfd, ev))
                if len(hits) >= maxevents:
                    break
        return hits

    def _poll_ready(self, interest):
        """poll() readiness over an explicit {vfd: events} interest
        set (POLLIN/POLLOUT share EPOLL bit values)."""
        hits = []
        for vfd, events in interest.items():
            ev = self._events_of(vfd) & (events | EPOLLRDHUP | EPOLLHUP)
            if ev:
                hits.append((vfd, ev))
        return hits

    def _rsp_events(self, hits):
        """Multi-event epoll_wait/poll answer: header with the count,
        then one (fd, events) pair per event (shim_preload.c evpair)."""
        out = RSP.pack(len(hits), 0, 0)
        for vfd, ev in hits:
            out += EVPAIR.pack(vfd, ev)
        self._send(out)

    def _take_vfd(self, vfd):
        """Adopt the C-side reserved fd number as a vfd id. The number
        is a live kernel fd in the child, so it cannot collide with
        another LIVE vfd — a collision means close-tracking desynced,
        which must fail loud, not corrupt state."""
        vfd = int(vfd)
        if vfd in self.vfds or vfd in self.epolls:
            raise ShimProtocolError(
                f"vfd {vfd} re-reserved while live (close-tracking "
                "desync)")
        return vfd

    def _rsp_accept(self, vs, cfd):
        """Pop one pending child off a listener and answer the accept
        call with the C-reserved child fd (shared by the immediate and
        parked paths)."""
        child, src, sport, conn = vs.accept_q.pop(0)
        cfd = self._take_vfd(cfd)
        cvs = _VSock(kind="tcp")
        cvs.sock = child
        cvs.connected = True
        cvs.conn = conn
        cvs.is_client = False
        self._open_streams(cvs)
        self.vfds[cfd] = cvs
        self.by_sock[id(child)] = cfd
        if child.slot is not None:
            self.by_key[(child.slot, child.gen)] = cfd
            cvs.key = (child.slot, child.gen)
        # peer identity: (virtual host id, port) off the handshake —
        # servers keying state by accept() address see distinct
        # simulated clients
        self._rsp(cfd, src, sport)

    def _maybe_unpark(self):
        """Answer the child's parked blocking call if a wake has made
        it ready. One parked call at most (single-threaded child)."""
        if self.parked is None:
            return False
        kind = self.parked[0]
        if kind == "epoll":
            _, epfd, maxev = self.parked
            hits = self._ready(epfd, maxev)
            if not hits:
                return False
            self.parked = None
            self._rsp_events(hits)
            return True
        if kind == "poll":
            interest = self.parked[1]
            hits = self._poll_ready(interest)
            if not hits:
                return False
            self.parked = None
            self._rsp_events(hits)
            return True
        if kind == "connect":
            vfd = self.parked[1]
            vs = self.vfds.get(vfd)
            if vs is None or vs.eof:
                self.parked = None
                self._rsp(-1, ECONNREFUSED)
                return True
            if vs.connected:
                self.parked = None
                self._rsp(0)
                return True
            return False
        if kind == "recv":
            _, vfd, n = self.parked
            vs = self.vfds.get(vfd)
            if vs is None:
                self.parked = None
                self._rsp_data(0)
                return True
            if vs.avail > 0 or vs.eof:
                k = min(vs.avail, n)
                vs.avail -= k
                self.parked = None
                self._rsp_data(k, self._rx_payload(vs, k))  # 0 = EOF
                return True
            return False
        if kind in ("recvd", "recvfrom"):
            _, vfd, n = self.parked
            vs = self.vfds.get(vfd)
            if vs is None or not vs.dgrams:
                return False
            src, sport, nbytes = vs.dgrams.pop(0)
            self.parked = None
            if kind == "recvfrom":
                # OP_RECVFROM answers never carry payload (r1/r2 are
                # the datagram's source identity; the C side zero-fills)
                self._rsp(min(n, nbytes), src, sport)
            else:
                self._rsp_data(min(n, nbytes))
            return True
        if kind == "accept":
            _, vfd, cfd = self.parked
            vs = self.vfds.get(vfd)
            if vs is None or not vs.accept_q:
                return False
            self.parked = None
            self._rsp_accept(vs, cfd)
            return True
        # "sleep" parks resolve only via their timer (on_timer)
        return False

    def _sweep_streams(self):
        """Runs when the child is gone (exit or terminate). Drops the
        streams I READ (my subscriptions — nothing will pop them
        again, and a hosted peer pushing into a dead subscriber would
        grow one unbounded, since subscribed streams are exempt from
        the reader-less cap) and reader-less streams I wrote. Streams
        the PEER subscribed stay: it may still be draining bytes I
        sent before exiting (a server that serves, closes and exits
        while the client reads); the peer drops them at its own
        close/exit. Streams under a close-time GRACE deferral also
        stay — dropping them here would defeat the grace window for a
        child that writes, closes and exits before the peer's
        establishment wake subscribes (the banner-then-close case):
        their pending TK_GRACE timers keep firing after child exit
        (on_timer runs without the child) and perform the deferred
        reader-less check then."""
        if self._payloads is None:
            return
        deferred = set(self._grace.values())
        for key in list(self._opened):
            if key in deferred:
                continue
            if key in self._mysubs or not self._payloads.subscribed(key):
                self._payloads.drop(key)
                self._opened.discard(key)
        self._mysubs.clear()

    # --- the service loop: run the child until it blocks ---
    def _service(self, os):
        """Run the child until it blocks — SUPERVISED: a hung child
        (watchdog), a malformed frame (protocol validation) or a
        channel failure becomes a diagnosed child death and the
        simulation continues; only the hosted process dies."""
        if self.exited:
            return
        try:
            self._maybe_unpark()
            while self.parked is None and not self.exited:
                req = self._read_req()
                if req is None:
                    self._child_gone(os)       # clean channel EOF
                    break
                if _DG.ENABLED:
                    self._op_chain = _hashlib.blake2b(
                        bytes.fromhex(self._op_chain) + REQ.pack(*req),
                        digest_size=8).hexdigest()
                # per-op protocol metrics: count + HANDLER latency (a
                # call that parks is counted when it arrives; the
                # sim-time it stays parked is not wall cost)
                # simlint: ok DET101 -- op-handler latency metric (wall-side)
                _t0 = _time.perf_counter_ns() if _MT.ENABLED else None
                self._handle(os, *req)
                if _t0 is not None:
                    _MT.shim_op(
                        OP_NAMES.get(req[0], str(req[0])),
                        # simlint: ok DET101 -- op latency metric (wall)
                        _time.perf_counter_ns() - _t0)
        except ShimHang as e:
            self._supervise_kill(os, f"hung: {e}")
        except ShimProtocolError as e:
            self._supervise_kill(os, f"protocol error: {e}")
        except (KeyError, IndexError, struct.error) as e:
            # a malformed opcode/operand must not surface as a
            # traceback that takes the simulator down (tentpole
            # contract): diagnose and kill the channel instead
            self._supervise_kill(
                os, f"protocol error: malformed request "
                    f"({type(e).__name__}: {e})")
        except OSError as e:
            self._supervise_kill(os, f"channel failure: {e}")
        if self.exited:
            self._sweep_streams()

    def _supervise_kill(self, os, cause):
        """Supervisor verdict: the child is unusable — SIGKILL it,
        record the diagnosis, tear its sockets down abortively."""
        import sys as _sys
        _sys.stderr.write(
            f"shadow_tpu_torch: shim[{_os.path.basename(self.argv[0])}]: "
            f"{cause} — killing hosted child; simulation continues\n")
        if _MT.ENABLED:
            _MT.REGISTRY.counter("shim.supervisor_kills").inc()
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
        self._child_gone(os, cause=cause)

    def _child_gone(self, os, cause=None):
        """The child is dead (clean exit, crash, or supervisor kill):
        record per-host exit status + cause, release the channel, and
        convert the sockets it left open into RST/EOF toward peers —
        the simulation keeps running (tentpole contract; the reference
        analogue is process teardown, shd-process.c:3195-3234)."""
        self.exited = True
        if self.proc is not None:
            try:
                self.proc.wait(timeout=5)
            except Exception:
                pass
            self.exit_status = self.proc.returncode
        if self.exit_cause is None:
            if cause is not None:
                self.exit_cause = cause
                self.exit_clean = False
            else:
                self.exit_cause, self.exit_clean = _status_cause(
                    self.exit_status)
        if os is not None and self.exit_sim_ns is None:
            self.exit_sim_ns = os.now()
        if _MT.ENABLED:
            _MT.REGISTRY.counter("shim.child_exits").inc()
        if self.chan is not None:
            try:
                self.chan.close()
            except OSError:
                pass
            self.chan = None
        self.parked = None
        if os is None:
            return
        # leftover socket teardown, deterministic vfd order. A clean
        # exit closes gracefully (the kernel FINs a closed fd) except
        # where delivered-but-unread bytes sit (a real stack RSTs
        # then); any diagnosed death resets everything.
        graceful = self.exit_clean
        for vfd in sorted(self.vfds):
            vs = self.vfds[vfd]
            for child, _, _, _ in vs.accept_q:
                os.abort(child)        # never-accepted server children
            vs.accept_q = []
            if vs.sock is not None and not vs.closed:
                if graceful and vs.avail == 0 and vs.kind != "listen":
                    os.close(vs.sock)
                else:
                    os.abort(vs.sock)
                vs.closed = True

    def op_stream_digest(self) -> str:
        """Running chain hash of every protocol request served so far
        (hosting.runtime.digest_state -> obs.digest records)."""
        return self._op_chain

    # --- checkpoint/resume (hosting.runtime snapshot/restore) ---
    def enable_journal(self):
        """Arm protocol-stream journaling (idempotent: a restored app
        keeps the journal it was pickled with)."""
        if self._journal is None:
            self._journal = []

    def disable_journal(self):
        """Drop the journal: a run that will never snapshot again
        (resume without --checkpoint) must not keep buffering the
        child's protocol traffic in RAM."""
        self._journal = None

    def __getstate__(self):
        """Checkpoint pickling: everything but the live OS process,
        its channel, the shared payload broker (runtime re-attaches)
        and the id()-keyed socket index (rebuilt on restore)."""
        d = dict(self.__dict__)
        for k in ("proc", "chan", "_payloads", "by_sock"):
            d.pop(k, None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.proc = None
        self.chan = None
        self._payloads = None
        self._replaying = False
        self.by_sock = {}
        for vfd, vs in self.vfds.items():
            if vs.sock is not None:
                self.by_sock[id(vs.sock)] = vfd

    def resume_replay(self, os):
        """Fast-forward a respawned child to the snapshot point: spawn
        the binary fresh and pump the journaled protocol stream — read
        back each request the original child issued (byte-compared:
        the shim virtualizes time, entropy and I/O, so a deterministic
        binary MUST reproduce it exactly) and answer with the recorded
        response bytes. No ops are re-issued and no simulator state is
        touched: the device arrays already hold the post-checkpoint
        truth; only the real OS process needs to catch up. Afterwards
        the child sits parked in the same blocked call the snapshot
        recorded. A byte divergence (non-deterministic child: wall
        clock, unvirtualized I/O, ...) is a diagnosed supervisor kill
        — loud in SimReport.hosted — never a desynced channel."""
        if self.exited or not self._started:
            return          # dead before the snapshot, or never ran
        if self._journal is None:
            self._supervise_kill(os, "resume: snapshot carries no "
                                     "protocol journal; cannot "
                                     "fast-forward the child")
            return
        self._replaying = True
        try:
            self._spawn()
            for dirn, data in self._journal:
                data = bytes(data)
                if dirn == "tx":
                    self.chan.sendall(data)
                    continue
                got = bytearray()
                while len(got) < len(data):
                    chunk = self._recv(len(data) - len(got))
                    if not chunk:
                        raise ShimProtocolError(
                            f"channel EOF {len(got)}/{len(data)} "
                            "bytes into a journaled request (child "
                            "died during replay)")
                    got += chunk
                if bytes(got) != data:
                    off = next(i for i, (x, y)
                               in enumerate(zip(got, data)) if x != y)
                    raise ShimProtocolError(
                        f"request stream diverged at byte {off} of a "
                        f"{len(data)}-byte journaled read")
        except (ShimHang, ShimProtocolError, OSError) as e:
            self._supervise_kill(
                os, "resume: journal replay diverged — the respawned "
                    f"child did not reproduce its recorded protocol "
                    f"stream ({e})")
        finally:
            self._replaying = False

    def exit_info(self) -> dict:
        """Per-host exit record for SimReport.hosted (None while the
        child is alive and unsupervised)."""
        if not self.exited and self.exit_cause is None:
            return None
        return {"exit_status": self.exit_status,
                "cause": self.exit_cause,
                "sim_ns": self.exit_sim_ns,
                "clean": bool(self.exit_clean),
                "violations": list(self.violations)}

    def rss_bytes(self):
        """Hosted child resident set (bytes) off /proc statm — the
        [ram] tracker column (reference shd-tracker.c:266 reports real
        process RSS; modeled hosts have none). None once dead."""
        if self.proc is None or self.proc.poll() is not None:
            return None
        try:
            with open(f"/proc/{self.proc.pid}/statm") as f:
                pages = int(f.read().split()[1])
            return pages * (_os.sysconf("SC_PAGE_SIZE"))
        except (OSError, ValueError, IndexError):
            return None

    def fault_kill(self, cause, sim_ns):
        """engine.faults host_down: SIGKILL the child and record the
        cause. No socket ops are issued — the injector scrubs the dead
        host's device state itself and radiates the RSTs."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            try:
                self.proc.wait(timeout=5)
            except Exception:
                pass
        if not self.exited:
            self.exit_status = (self.proc.returncode
                                if self.proc is not None else None)
            self.exit_cause = cause
            self.exit_sim_ns = sim_ns
            self.exit_clean = False
        self.exited = True
        self.parked = None
        if self.chan is not None:
            try:
                self.chan.close()
            except OSError:
                pass
            self.chan = None
        # the host is GONE: pending grace timers died with its event
        # queue, so perform their deferred reader-less drops now
        if self._payloads is not None:
            for key in self._grace.values():
                if not self._payloads.subscribed(key):
                    self._payloads.drop(key)
                    self._opened.discard(key)
        self._grace = {}
        self._sweep_streams()

    def _park_timer(self, os, ns, kind, operand=0):
        """Arm a sim-time timer tagged to the CURRENT park (park_seq
        must already be bumped). See the tag layout above."""
        os.timer(int(ns), tag=_tag(kind, operand, self.park_seq))

    def _handle(self, os, op, a, b, c, name):
        if op == OP_SEND and int(c) == 1:
            # a stream-socket send carries the app's REAL payload bytes
            # (b = n); consume them before anything else so the channel
            # stays framed even on error answers. Datagram sends set
            # c = 0 and OP_SENDTO never carries payload (UDP contents
            # are not materialized) — the C side stamps the flag from
            # its own per-fd state, so framing never depends on
            # mirrored tables
            payload = self._read_n(b)   # raises ShimProtocolError on
            #                             EOF mid-frame (supervised)
        else:
            payload = b""
        if op == OP_POLL:
            raw = self._read_n(b)
            interest = {}
            for i in range(int(a)):
                fd, events = EVPAIR.unpack_from(raw, i * EVPAIR.size)
                interest[int(fd)] = interest.get(int(fd), 0) | int(events)
            hits = self._poll_ready(interest)
            timeout_ms = int(c)
            if hits:
                self._rsp_events(hits)
            elif timeout_ms == 0:
                self._rsp_events([])
            else:
                self.parked = ("poll", interest)
                self.park_seq += 1
                if timeout_ms > 0:
                    self._park_timer(os, timeout_ms * 1_000_000, TK_POLL)
            return
        if op == OP_SOCKET:
            vfd = self._take_vfd(b)
            self.vfds[vfd] = _VSock(kind="udp" if a else "tcp")
            self._rsp(vfd)
        elif op == OP_BIND:
            vs = self.vfds[a]
            vs.bound_port = int(b)
            if vs.kind == "udp":
                vs.sock = os.udp_open(port=int(b))
                self.by_sock[id(vs.sock)] = a
            self._rsp(0)
        elif op == OP_LISTEN:
            vs = self.vfds[a]
            vs.kind = "listen"
            vs.sock = os.tcp_listen(vs.bound_port)
            self.by_sock[id(vs.sock)] = a
            self._rsp(0)
        elif op == OP_ACCEPT:
            vs = self.vfds[a]
            if vs.accept_q:
                self._rsp_accept(vs, int(c))
            elif int(b) & 1:             # blocking listener: park
                self.parked = ("accept", a, int(c))
                self.park_seq += 1
            else:
                self._rsp(-1, EAGAIN)
        elif op == OP_SENDTO:
            vs = self.vfds[a]
            if vs.sock is None:        # unbound UDP: ephemeral port
                vs.sock = os.udp_open(port=0)
                self.by_sock[id(vs.sock)] = a
            dst = int(c) >> 16
            port = int(c) & 0xFFFF
            os.sendto(vs.sock, dst, port, int(b))
            self._rsp(b)
        elif op == OP_RECVFROM:
            vs = self.vfds[a]
            if vs.dgrams:
                src, sport, nbytes = vs.dgrams.pop(0)
                self._rsp(min(int(b), nbytes), src, sport)
            elif int(c) & 1:             # blocking: park until a dgram
                self.parked = ("recvfrom", a, int(b))
                self.park_seq += 1
            else:
                self._rsp(-1, EAGAIN)
        elif op == OP_CONNECT:
            vs = self.vfds[a]
            blk = (int(c) >> 16) & 1
            c = int(c) & 0xFFFF
            if vs.kind == "udp":
                # connected-UDP: record the default destination; no
                # handshake, succeeds immediately
                vs.bound_port = -1       # marker unused for udp
                vs.dgram_dst = (int(b), int(c))
                if vs.sock is None:
                    vs.sock = os.udp_open(port=0)
                    self.by_sock[id(vs.sock)] = a
                self._rsp(0)
            else:
                vs.sock = os.tcp_connect(int(b), int(c))
                self.by_sock[id(vs.sock)] = a
                if blk:                  # blocking connect: park until
                    self.parked = ("connect", a)   # established
                    self.park_seq += 1
                else:
                    self._rsp(-1, EINPROGRESS)  # completes via EPOLLOUT
        elif op == OP_SEND:
            vs = self.vfds[a]
            if vs.kind == "udp":
                if vs.dgram_dst is None:
                    self._rsp(-1, ENOTCONN)
                else:
                    dst, port = vs.dgram_dst
                    if vs.sock is None:
                        vs.sock = os.udp_open(port=0)
                        self.by_sock[id(vs.sock)] = a
                    os.sendto(vs.sock, dst, port, int(b))
                    self._rsp(b)
            else:
                self._tx_payload(vs, payload)
                os.write(vs.sock, int(b))
                self._rsp(b)
        elif op == OP_RECV:
            vs = self.vfds[a]
            blk = int(c) & 1
            if vs.kind == "udp":         # recv() on a datagram socket
                if vs.dgrams:
                    _src, _sp, nbytes = vs.dgrams.pop(0)
                    self._rsp_data(min(int(b), nbytes))
                elif blk:
                    self.parked = ("recvd", a, int(b))
                    self.park_seq += 1
                else:
                    self._rsp(-1, EAGAIN)
            else:
                n = min(vs.avail, int(b))
                vs.avail -= n
                if n == 0 and not vs.eof:
                    if blk:              # blocking read: park until
                        self.parked = ("recv", a, int(b))  # data/EOF
                        self.park_seq += 1
                    else:
                        self._rsp(-1, EAGAIN)
                else:
                    self._rsp_data(n, self._rx_payload(vs, n))  # 0 = EOF
        elif op in (OP_CLOSE, OP_SHUTDOWN):
            if op == OP_CLOSE and a in self.epolls:
                # closing an epoll instance: forget its interest set
                # (with C-reserved fd numbers the number WILL be
                # reused; stale state would collide in _take_vfd)
                del self.epolls[a]
                self._rsp(0)
                return
            vs = self.vfds.get(a)
            if vs is not None and vs.sock is not None and not vs.closed:
                os.close(vs.sock)
                vs.closed = True
            if op == OP_CLOSE:
                gone = self.vfds.pop(a, None)
                if gone is not None and gone.key is not None:
                    self.by_key.pop(gone.key, None)
                if gone is not None:
                    self.by_sock.pop(id(gone.sock), None)
                    if (gone.conn is not None and
                            self._payloads is not None):
                        # I was the reader of my in-direction; the peer
                        # drops the other one at its own close
                        key = gone.conn + (1 if gone.is_client else 0,)
                        self._payloads.drop(key)
                        self._opened.discard(key)
                        self._mysubs.discard(key)
                        # my OUT-direction: if no reader subscribed YET,
                        # the peer is either modeled (nothing will ever
                        # drain it) or a hosted process whose
                        # establishment wake hasn't arrived (a server
                        # that writes and closes within its accept
                        # window — banner-then-close). Don't drop now:
                        # give the peer a sim-time GRACE window to
                        # subscribe, then drop if still reader-less
                        # (an immediate drop would silently discard
                        # such a server's bytes)
                        out = gone.conn + (0 if gone.is_client else 1,)
                        if not self._payloads.subscribed(out):
                            gid = self._next_grace & 0xFFFFF
                            self._next_grace += 1
                            self._grace[gid] = out
                            os.timer(GRACE_NS, tag=_tag(TK_GRACE, gid, 0))
                for watch in self.epolls.values():
                    watch.pop(a, None)
            self._rsp(0)
        elif op == OP_EPOLL_CREATE:
            vfd = self._take_vfd(b)
            self.epolls[vfd] = {}
            self._rsp(vfd)
        elif op == OP_EPOLL_CTL:
            ctl = int(b) & 0xFFFFFFFF
            events = int(b) >> 32
            watch = self.epolls.setdefault(a, {})
            if ctl == EPOLL_CTL_DEL:
                watch.pop(int(c), None)
            else:
                watch[int(c)] = events
            self._rsp(0)
        elif op == OP_EPOLL_WAIT:
            maxev = max(int(c), 1)
            hits = self._ready(a, maxev)
            if hits:
                self._rsp_events(hits)
            elif b == 0:
                self._rsp(0)             # pure poll: never parks
            else:
                # block until a wake readies it
                self.parked = ("epoll", a, maxev)
                self.park_seq += 1
                if b > 0:                # bounded wait: sim-time timer
                    self._park_timer(os, int(b) * 1_000_000, TK_EPOLL, a)
        elif op == OP_SLEEP:
            # sleeping advances SIM time (reference shd-process.c:3055):
            # park until the deadline timer fires
            self.parked = ("sleep",)
            self.park_seq += 1
            self._park_timer(os, int(b), TK_SLEEP)
        elif op == OP_RANDOM:
            # deterministic entropy from the host PRNG (reference
            # shd-host.c:574; determinism shd-test-determinism.c)
            n = max(int(b), 0)
            self._rsp_data(n, os.random_bytes(n))
        elif op == OP_GETNAME:
            vs = self.vfds.get(a)
            if vs is None:
                self._rsp(-1, ENOTCONN)
            else:
                self._rsp(*self._name_of(os, vs, which=int(b)))
        elif op == OP_VIOLATION:
            # the child attempted a refused operation (fork/vfork/
            # exec*: shim_preload.c returned ENOSYS); record the
            # diagnostic so the refusal is visible in the exit report
            # and metrics, not only on the child's stderr
            what = name.rstrip(b"\0").decode(errors="replace") or "?"
            self.violations.append(what)
            import sys as _sys
            _sys.stderr.write(
                f"shadow_tpu_torch: shim[{_os.path.basename(self.argv[0])}]:"
                f" child attempted {what} — refused (ENOSYS)\n")
            if _MT.ENABLED:
                _MT.REGISTRY.counter("shim.violations").inc()
            self._rsp(0)
        elif op == OP_CLOCK:
            self._rsp(os.now())
        elif op == OP_RESOLVE:
            try:
                hid = os.resolve(name.rstrip(b"\0").decode())
            except Exception:
                hid = -1
            self._rsp(hid)
        else:
            # an opcode this side does not speak is framing poison:
            # its (unknown) trailing payload would desync every later
            # frame — diagnosed channel kill, not a guessed answer
            raise ShimProtocolError(f"unknown opcode {int(op)}")

    def _name_of(self, os, vs, which):
        """getsockname (which=0) / getpeername (which=1) answer:
        (0, host, port) from the connection identity, or the bound
        port pre-establishment."""
        if vs.conn is not None:
            cli_host, cli_port, srv_host, srv_port = vs.conn
            if which == 0:
                return (0, os.host_id,
                        cli_port if vs.is_client else srv_port)
            return ((0, srv_host, srv_port) if vs.is_client
                    else (0, cli_host, cli_port))
        if which == 0:
            return (0, os.host_id, max(vs.bound_port, 0))
        if vs.kind == "udp" and vs.dgram_dst is not None:
            return (0, vs.dgram_dst[0], vs.dgram_dst[1])
        return (-1, ENOTCONN, 0)

    # --- hosted-app callbacks: map device wakes to epoll readiness ---
    def on_start(self, os):
        self._spawn()
        self._service(os)

    def _vs_of(self, sock):
        vfd = self.by_sock.get(id(sock))
        if vfd is None and sock is not None and sock.slot is not None:
            vfd = self.by_key.get((sock.slot, sock.gen))
        if vfd is None:
            return None, None
        vs = self.vfds.get(vfd)
        if (sock.slot is not None and vs is not None):
            self.by_key[(sock.slot, sock.gen)] = vfd
            vs.key = (sock.slot, sock.gen)
        return vfd, vs

    def on_connected(self, os, sock, lport=0, peer=(0, 0)):
        _, vs = self._vs_of(sock)
        if vs is not None:
            vs.connected = True
            if vs.conn is None and lport:
                # payload stream identity off the SYN|ACK: we are the
                # client side of (cli_host, cli_port, srv_host, srv_port)
                vs.conn = (os.host_id, int(lport),
                           int(peer[0]), int(peer[1]))
                vs.is_client = True
                self._open_streams(vs)
        self._service(os)

    def on_accept(self, os, sock, tag, dport=0, peer=(0, 0)):
        # queue the accepted child on its listener, matched by bound
        # port (fall back to the only listener when ports are unset)
        target = None
        for vs in self.vfds.values():
            if vs.kind == "listen":
                if vs.bound_port == dport or target is None:
                    target = vs
                    if vs.bound_port == dport:
                        break
        if target is not None:
            matched = (not dport) or target.bound_port == dport
            conn = (int(peer[0]), int(peer[1]), os.host_id,
                    int(dport) or target.bound_port)
            target.accept_q.append((sock, peer[0], peer[1], conn))
            # subscribe our inbound direction NOW, at the wake — not
            # at the app's accept() call, which it may make arbitrarily
            # later: the client's first pushes land between this wake
            # and that call, and an unsubscribed stream would cap and
            # die under them (api.PayloadBroker.push). ONLY when the
            # SYN's port matched the listener — a mismatched fallback
            # connection may never be accepted, and its subscribed
            # (cap-exempt) stream would accumulate forever; if the app
            # does accept it, _rsp_accept's
            # _open_streams subscribes then, with the cap protecting
            # the interim
            if self._payloads is not None and matched:
                for d in (0, 1):
                    self._payloads.open(conn + (d,))
                    self._opened.add(conn + (d,))
                self._payloads.subscribe(conn + (0,))
                self._mysubs.add(conn + (0,))
        self._service(os)

    def on_dgram(self, os, sock, src, sport, nbytes, aux):
        # WAKE_SOCKET: TCP delivered bytes, or a UDP datagram
        _, vs = self._vs_of(sock)
        if vs is not None:
            if vs.kind == "udp":
                vs.dgrams.append((int(src), int(sport), int(nbytes)))
            else:
                vs.avail += int(nbytes)
        self._service(os)

    def on_eof(self, os, sock):
        _, vs = self._vs_of(sock)
        if vs is not None:
            vs.eof = True
        self._service(os)

    def on_sent(self, os, sock):
        self._service(os)

    def on_timer(self, os, tag):
        kind = (tag >> 20) & 0x7
        seq = (tag >> 24) & 0x7F
        operand = tag & 0xFFFFF
        if kind == TK_GRACE:
            # deferred payload-stream drop (see OP_CLOSE): drop only if
            # still reader-less — a peer that subscribed meanwhile owns
            # the stream until ITS close
            key = self._grace.pop(operand, None)
            if (key is not None and self._payloads is not None and
                    not self._payloads.subscribed(key)):
                self._payloads.drop(key)
                self._opened.discard(key)
        elif (kind == TK_EPOLL and self.parked is not None and
                self.parked[0] == "epoll" and
                (self.parked[1] & 0xFFFFF) == operand and
                seq == (self.park_seq & 0x7F)):
            # epoll_wait timeout expiry: answer 0 events iff the child
            # is still parked in the SAME wait that armed this timer
            self.parked = None
            self._rsp(0)
        elif (kind == TK_POLL and self.parked is not None and
                self.parked[0] == "poll" and
                seq == (self.park_seq & 0x7F)):
            self.parked = None
            self._rsp_events([])
        elif (kind == TK_SLEEP and self.parked is not None and
                self.parked[0] == "sleep" and
                seq == (self.park_seq & 0x7F)):
            self.parked = None
            self._rsp(0)
        self._service(os)

    def terminate(self):
        """End-of-run cleanup: release the child and the channel (a
        stop_time truncation can leave the child parked forever)."""
        if self.chan is not None:
            try:
                self.chan.close()
            except OSError:
                pass
            self.chan = None
        if self.proc is not None:
            was_alive = self.proc.poll() is None
            if was_alive:
                self.proc.terminate()
                try:
                    self.proc.wait(timeout=5)
                except Exception:
                    self.proc.kill()
                    try:
                        self.proc.wait(timeout=5)
                    except Exception:
                        pass
            if self.exit_status is None:
                self.exit_status = self.proc.returncode
            if self.exit_cause is None:
                if was_alive:
                    # truncated by the stop time while healthy — a
                    # normal end for a long-running hosted process
                    self.exit_cause = "terminated at end of run"
                    self.exit_clean = True
                else:
                    # the child had already died on its own but the
                    # death was never serviced (e.g. crashed while
                    # parked): report the REAL status, not a healthy
                    # truncation
                    self.exit_cause, self.exit_clean = _status_cause(
                        self.exit_status)
        self.exited = True
        self._sweep_streams()


register("shim", ShimApp)
