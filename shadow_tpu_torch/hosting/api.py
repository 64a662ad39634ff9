"""CPU-side hosted-application API.

A copy of ``shadow_tpu/hosting/api.py`` with a registry of the port's
own (hosted apps register with each package they run under). This is
what replaces writing a C plugin against libc + LD_PRELOAD in
the reference (SURVEY §2.4/2.5): a hosted app is real Python code
driven by the same wake reasons on-device apps get, issuing syscalls
against a per-host :class:`HostOS` handle. Syscalls are batched and
applied to device state between lookahead windows (hosting.bridge), so
apps see the engine's real TCP/UDP stack.

Determinism: apps must derive randomness from ``os.random()`` (seeded
per host from the scenario seed) and time from ``os.now()`` (simulated
nanoseconds) — mirroring how the reference virtualizes /dev/random and
clock_gettime for plugins (shd-process.c:4329-4650).
"""

from __future__ import annotations

from dataclasses import dataclass, field


class Sock:
    """Handle for one socket INCARNATION: a (device slot, generation)
    pair. Slots are recycled after close; the generation (stamped on
    every wake by the engine) keeps a handle bound to exactly the
    connection that created it. Resolves after the op batch that
    created it is applied; hosted apps only dereference it in later
    callbacks, by which time it is bound."""

    __slots__ = ("slot", "gen")

    def __init__(self):
        self.slot = None
        self.gen = None

    def __index__(self):
        if self.slot is None:
            raise RuntimeError("Sock used before its open op applied")
        return self.slot

    def __repr__(self):
        return f"Sock({self.slot}@{self.gen})"


@dataclass
class _PendingOp:
    code: int
    a: int = 0
    b: int = 0
    c: int = 0
    d: int = 0
    t: int = 0          # sim time the op was issued (its wake's time)
    out: Sock = None


class HostOS:
    """Per-host syscall surface handed to hosted app callbacks.

    The call set mirrors the host_* syscall backend of the reference
    (shd-host.c:598-1556) at the same granularity the on-device apps
    use: byte-counted streams and tagged datagrams.
    """

    def __init__(self, host_id: int, name: str, rng, dns, clock):
        self.host_id = host_id
        self.name = name
        self._rng = rng
        self._dns = dns
        self._clock = clock          # callable -> current sim time ns
        self._ops: list = []
        self._socks: dict = {}       # (slot, gen) -> Sock (live handles;
        #   entries are dropped at close so the map is bounded by
        #   concurrently-open sockets)

    # --- environment ---
    def now(self) -> int:
        """Simulated time, nanoseconds."""
        return self._clock()

    def random(self) -> float:
        """Deterministic per-host uniform [0, 1)."""
        return float(self._rng.random())

    def random_bytes(self, n: int) -> bytes:
        """n deterministic entropy bytes from the per-host PRNG — the
        backing store for hosted getrandom/getentropy//dev/u?random
        (reference: the host random source serves /dev/random reads,
        shd-host.c:574, which is what makes entropy-drawing binaries
        run identically across runs, shd-test-determinism.c:15-60)."""
        return self._rng.bytes(int(n))

    def resolve(self, name: str) -> int:
        """Virtual DNS lookup -> host id."""
        return self._dns.resolve(name)

    # --- sockets ---
    def udp_open(self, port: int = 0) -> Sock:
        return self._push_open(1, a=port)

    def tcp_listen(self, port: int) -> Sock:
        return self._push_open(2, a=port)

    def tcp_connect(self, dst, port: int, tag: int = 0) -> Sock:
        dst = self.resolve(dst) if isinstance(dst, str) else int(dst)
        return self._push_open(3, a=dst, b=port, c=tag)

    def write(self, sock, nbytes: int):
        self._push(_PendingOp(4, a=self._slot(sock), b=int(nbytes)))

    def sendto(self, sock, dst, port: int, nbytes: int, aux: int = 0):
        dst = self.resolve(dst) if isinstance(dst, str) else int(dst)
        self._push(_PendingOp(
            5, a=self._slot(sock), b=dst,
            c=(int(port) << 32) | (int(aux) & 0xFFFFFFFF), d=int(nbytes)))

    def close(self, sock):
        self._push(_PendingOp(6, a=self._slot(sock)))
        # retire the incarnation's handle so _socks stays bounded by
        # open sockets, not by connections ever opened; a late wake for
        # the closed incarnation just materializes a fresh handle
        if isinstance(sock, Sock) and sock.slot is not None:
            self._socks.pop((sock.slot, sock.gen), None)

    def abort(self, sock):
        """Abortive close (net.tcp.tcp_abort_call): an established TCP
        connection sends RST toward the peer instead of draining a FIN;
        anything else frees immediately. The teardown a supervisor
        issues for a dead hosted process's leftover sockets — the peer
        sees a reset, as it would from a real kernel reaping a killed
        process."""
        self._push(_PendingOp(9, a=self._slot(sock)))
        if isinstance(sock, Sock) and sock.slot is not None:
            self._socks.pop((sock.slot, sock.gen), None)

    def timer(self, delay_ns: int, tag: int = 0):
        self._push(_PendingOp(7, a=self.now() + int(delay_ns),
                              b=int(tag)))

    def pipe(self):
        """A linked pair of pipe halves (the reference's Channel,
        shd-channel.c): write on one half wakes the other with the
        byte count; close delivers EOF. Returns (Sock, Sock). The
        handles resolve at the next wake — use them in a LATER
        callback, not the one that created them (same-batch Sock
        references cannot name one half of a pair)."""
        sa, sb = Sock(), Sock()
        self._push(_PendingOp(8, out=(sa, sb)))
        return sa, sb

    # --- internals ---
    def _push(self, op: _PendingOp):
        op.t = self.now()
        self._ops.append(op)

    def _push_open(self, code, a=0, b=0, c=0) -> Sock:
        s = Sock()
        self._push(_PendingOp(code, a=a, b=b, c=c, out=s))
        return s

    def _slot(self, sock):
        """A slot operand: an int, a resolved Sock, or an unresolved
        Sock created earlier in this same batch (the runtime encodes
        the latter as a same-batch result reference, resolved on
        device — so `sock = os.udp_open(); os.sendto(sock, ...)` works
        within one callback)."""
        if isinstance(sock, Sock):
            return sock if sock.slot is None else sock.slot
        return int(sock)

    def sock_for(self, slot: int, gen: int = 0) -> Sock:
        """Sock handle for a wake's (slot, generation) — the SAME
        object for every wake of one connection incarnation
        (server-accepted children get their first handle here)."""
        s = self._socks.get((slot, gen))
        if s is None:
            s = Sock()
            s.slot = slot
            s.gen = gen
            self._socks[(slot, gen)] = s
        return s

    def _bind(self, sock: Sock, packed: int):
        """Bind an open's result: packed = (generation << 16) | slot,
        or -1 on failure."""
        if packed < 0:
            sock.slot = -1
            sock.gen = -1
            return
        sock.slot = packed & 0xFFFF
        sock.gen = (packed >> 16) & 0x7FFF
        self._socks[(sock.slot, sock.gen)] = sock

    def _bind_pipe(self, sa: Sock, sb: Sock, packed: int):
        """Bind a pipe open's packed pair:
        gen_a(7) | slot_a(8) | gen_b(7) | slot_b(8)."""
        if packed < 0:
            for s in (sa, sb):
                s.slot = -1
                s.gen = -1
            return
        sa.slot = (packed >> 15) & 0xFF
        sa.gen = (packed >> 23) & 0x7F
        sb.slot = packed & 0xFF
        sb.gen = (packed >> 8) & 0x7F
        self._socks[(sa.slot, sa.gen)] = sa
        self._socks[(sb.slot, sb.gen)] = sb


class PayloadBroker:
    """Host-side per-connection byte streams for hosted apps.

    The engine models byte COUNTS (a DES does not move payloads across
    the device); when BOTH endpoints of a TCP connection are hosted
    processes in this simulator, the real bytes can ride host-side: the
    sender's app appends what it wrote, the receiver pops exactly the
    count the engine delivered. Delivered counts are in-order stream
    advances bounded by what was sent, so a FIFO per (connection,
    direction) reproduces the exact bytes a real network would have
    delivered. Streams a hosted endpoint writes toward a MODELED peer
    have no reader; they are capped (and dropped on overflow) so a
    long run cannot accumulate unbounded buffers — readers of such
    connections see zero-fill, same as before payloads existed.

    Keys: (cli_host, cli_port, srv_host, srv_port, direction) with
    direction 0 = client->server, 1 = server->client. Both endpoints
    derive the same tuple — the server from its accept wake's peer
    identity, the client from its connected wake's local port (the
    SYN|ACK's DPORT). A 4-tuple reused by a LATER connection (ephemeral
    wrap + TIME_WAIT recycling) could alias a stream whose endpoints
    never closed; closes drop each side's stream so this needs both
    processes to leak the socket — accepted and documented here.
    """

    CAP = 64 << 20  # in-flight bound for READER-LESS streams (a hosted
    #   endpoint writing toward a modeled process: no one ever pops)

    def __init__(self):
        self._streams: dict = {}   # key -> bytearray (None = overflowed)
        # keys whose actual READER registered (subscribe()): these
        # streams are never capped (the reader drains them at modeled
        # delivery pace) and survive the writer's close until the
        # reader closes. Reader-less keys — the peer process is a
        # modeled app, even one sharing a host with a hosted app — are
        # capped and dropped at the writer's close.
        self._subs: set = set()

    def open(self, key):
        """Idempotent create: both endpoints open both directions at
        connection establishment, so a writer's first push always finds
        the stream (the accept wake precedes the connected wake in sim
        time; create-only keeps the later open from clearing bytes the
        earlier side already pushed). An overflow-dead marker (None) is
        revived: it belongs to a previous connection incarnation."""
        if self._streams.get(key) is None:   # absent OR overflow-dead
            self._streams[key] = bytearray()

    def subscribe(self, key):
        """Register as the READER of `key` (each endpoint subscribes
        its inbound direction at establishment)."""
        self.open(key)
        self._subs.add(key)

    def subscribed(self, key) -> bool:
        return key in self._subs

    def push(self, key, data: bytes):
        buf = self._streams.get(key)
        if buf is None:
            return                      # no stream (modeled peer never
        #                                 opened it) or overflowed
        if key not in self._subs and len(buf) + len(data) > self.CAP:
            self._streams[key] = None   # cap blown on a reader-less
            #   stream (modeled peer); stop buffering — a subscribed
            #   stream is never capped, its reader drains it
            return
        buf += data

    def pop(self, key, n: int):
        """Exactly n bytes off the stream front, or None when the
        stream cannot cover the request — absent, overflow-dead, or
        shorter than n. A live writer always stays ahead of delivered
        counts (bytes are pushed at send time, delivery follows by the
        modeled latency), so a short stream means no real writer backs
        it (modeled peer: perpetually empty) or a degraded one
        (crashed peer / reused key); the caller zero-fills locally and
        no padding bytes cross the control channel.

        A SHORT stream (nonempty but < n) is marked overflow-dead: one
        uncovered read has already zero-filled, so later covered pops
        would return real bytes at the wrong stream offset — shifted
        partial replay is worse than degrading to consistent zero-fill."""
        buf = self._streams.get(key)
        if buf is None:
            return None
        if len(buf) < n:
            if len(buf) > 0:
                self._streams[key] = None
            return None
        out = bytes(buf[:n])
        del buf[:n]
        return out

    def drop(self, key):
        self._streams.pop(key, None)
        self._subs.discard(key)


class HostedApp:
    """Base class for hosted applications. Override the callbacks you
    need; each receives the HostOS handle first."""

    def on_start(self, os: HostOS):
        pass

    def on_timer(self, os: HostOS, tag: int):
        pass

    def on_connected(self, os: HostOS, sock: Sock, lport: int = 0,
                     peer: tuple = (0, 0)):
        """`lport` is the connection's local (ephemeral) port and
        `peer` = (virtual host id, port) of the server — both off the
        SYN|ACK that completed the handshake, mirroring on_accept's
        identity args on the passive side."""
        pass

    def on_accept(self, os: HostOS, sock: Sock, tag: int, dport: int = 0,
                  peer: tuple = (0, 0)):
        """`sock` is the accepted CHILD connection; `dport` the local
        port it arrived on (identifies the listener when the app has
        several); `peer` = (virtual host id, port) of the connecting
        client."""
        pass

    def on_eof(self, os: HostOS, sock: Sock):
        pass

    def on_sent(self, os: HostOS, sock: Sock):
        pass

    def on_dgram(self, os: HostOS, sock: Sock, src: int, sport: int,
                 nbytes: int, aux: int):
        pass


# --- hosted-plugin registry (the analogue of <plugin id path>) ---

_REGISTRY: dict = {}


def register(name: str, factory):
    """Register a hosted app factory: factory(args_str) -> HostedApp."""
    _REGISTRY[name] = factory


def lookup(name: str):
    if name not in _REGISTRY:
        # built-in hosted apps register at import; pull them in before
        # giving up (the LD_PRELOAD shim bridge lives in .shim)
        from . import shim  # noqa: F401
    if name not in _REGISTRY:
        raise ValueError(
            f"no hosted app {name!r} registered "
            f"(have: {sorted(_REGISTRY)}); call hosting.register first")
    return _REGISTRY[name]
