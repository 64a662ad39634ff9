"""Native (C ABI) hosted plugins.

Counterpart of ``shadow_tpu/hosting/cplugin.py``; plugins build into the
port's build directory (``hosting.build.build_dir``).

The reference hosts unmodified ELF binaries by interposing libc and
loading each instance into its own linker namespace (SURVEY §2.4/2.5:
elf-loader + rpth + libshadow-interpose). The equivalent here
keeps the same boundary with explicit mechanics: a plugin is a shared
object exporting event callbacks against a syscall vtable — the same
HostedApp surface Python apps use, crossing into C via ctypes. Every
host instance gets its own opaque state pointer, so one .so serves
thousands of isolated instances (the role dlmopen namespaces played).

C ABI (see examples/plugins/cping.c):

    typedef struct {
        long long (*now)(void* os);          // sim time ns
        double    (*rnd)(void* os);          // deterministic uniform
        int  (*udp_open)(void* os, int port);     // -> pending sock id
        int  (*tcp_connect)(void* os, int dst_host, int port, int tag);
        int  (*tcp_listen)(void* os, int port);
        void (*send_to)(void* os, int sock, int dst_host, int port,
                        long long nbytes, int aux);
        void (*write_sk)(void* os, int sock, long long nbytes);
        void (*close_sk)(void* os, int sock);
        void (*timer)(void* os, long long delay_ns, int tag);
        int  (*resolve)(void* os, const char* name);
    } shadow_os_api;

    void* plugin_create(const char* args);
    void  plugin_destroy(void* st);
    // reasons mirror engine.defs WAKE_*; a/b/c carry slot/src/len|tag
    void  plugin_on_wake(void* st, void* os, const shadow_os_api* api,
                         int reason, int a, int b, long long c);

Socket ids on the C side are the HostOS pending handles resolved after
the batch applies (the same deferred-binding Python apps get).
"""

from __future__ import annotations

import ctypes
import os

from .api import HostedApp, register
from .build import build_dir, compile_c

_API_FIELDS = [
    ("now", ctypes.CFUNCTYPE(ctypes.c_longlong, ctypes.c_void_p)),
    ("rnd", ctypes.CFUNCTYPE(ctypes.c_double, ctypes.c_void_p)),
    ("udp_open", ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_int)),
    ("tcp_connect", ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int)),
    ("tcp_listen", ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_int)),
    ("send_to", ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_int)),
    ("write_sk", ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_longlong)),
    ("close_sk", ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_int)),
    ("timer", ctypes.CFUNCTYPE(None, ctypes.c_void_p,
                               ctypes.c_longlong, ctypes.c_int)),
    ("resolve", ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_char_p)),
]


class _OsApi(ctypes.Structure):
    _fields_ = _API_FIELDS


_loaded = {}


def _load(so_path: str):
    lib = _loaded.get(so_path)
    if lib is None:
        lib = ctypes.CDLL(so_path)
        lib.plugin_create.restype = ctypes.c_void_p
        lib.plugin_create.argtypes = [ctypes.c_char_p]
        lib.plugin_destroy.argtypes = [ctypes.c_void_p]
        lib.plugin_on_wake.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(_OsApi),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
        _loaded[so_path] = lib
    return lib


def build_plugin(c_path: str, so_path: str = None) -> str:
    """Compile a plugin source with g++ (once; mtime-checked) into
    `so_path`, by default ``<build dir>/<source name>.so``."""
    so_path = so_path or os.path.join(
        build_dir(), os.path.splitext(os.path.basename(c_path))[0] + ".so")
    return compile_c(["g++", "-O2", "-shared", "-fPIC", c_path, "-o"],
                     so_path, c_path)


class CPluginApp(HostedApp):
    """Bridges one native plugin instance into the HostedApp callbacks.

    Socket identity: the C side works with small integer handles that
    index this instance's Sock table (pending HostOS handles); wakes
    translate device slots back to those handles.
    """

    def __init__(self, so_path: str, args: str):
        self.lib = _load(so_path)
        self.state = self.lib.plugin_create(args.encode())
        self._socks = []           # handle -> Sock (None = retired)
        self._free_handles = []    # retired handle indices for reuse
        self._handle_of = {}       # id(Sock) -> handle (stable: HostOS
        #   returns one object per connection incarnation)
        self._os = None
        # keep callback objects alive for the instance lifetime
        self._cbs = self._make_api()

    # --- C -> HostOS trampolines ---
    def _make_api(self):
        def now(_):
            return self._os.now()

        def rnd(_):
            return self._os.random()

        def _new_handle(sock) -> int:
            if self._free_handles:
                h = self._free_handles.pop()
                self._socks[h] = sock
            else:
                self._socks.append(sock)
                h = len(self._socks) - 1
            self._handle_of[id(sock)] = h
            return h

        self._new_handle = _new_handle

        def udp_open(_, port):
            return _new_handle(self._os.udp_open(port))

        def tcp_connect(_, dst, port, tag):
            return _new_handle(self._os.tcp_connect(dst, port, tag))

        def tcp_listen(_, port):
            return _new_handle(self._os.tcp_listen(port))

        def _live(h):
            """Handle -> Sock, or None for retired/invalid handles
            (double close or use-after-close from the plugin is treated
            as a no-op, like writes on a closed fd returning EBADF)."""
            if 0 <= h < len(self._socks):
                return self._socks[h]
            return None

        def send_to(_, h, dst, port, nbytes, aux):
            sock = _live(h)
            if sock is not None:
                self._os.sendto(sock, dst, port, nbytes, aux)

        def write_sk(_, h, nbytes):
            sock = _live(h)
            if sock is not None:
                self._os.write(sock, nbytes)

        def close_sk(_, h):
            sock = _live(h)
            if sock is None:
                return
            self._os.close(sock)
            # retire the handle: bounded by open sockets, not by
            # connections ever opened
            self._handle_of.pop(id(sock), None)
            self._socks[h] = None
            self._free_handles.append(h)

        def timer(_, delay_ns, tag):
            self._os.timer(delay_ns, tag)

        def resolve(_, name):
            return self._os.resolve(name.decode())

        fns = dict(now=now, rnd=rnd, udp_open=udp_open,
                   tcp_connect=tcp_connect, tcp_listen=tcp_listen,
                   send_to=send_to, write_sk=write_sk, close_sk=close_sk,
                   timer=timer, resolve=resolve)
        cbs = {k: t(fns[k]) for k, t in _API_FIELDS}
        self._api = _OsApi(**cbs)
        return cbs

    def _handle_of_slot(self, sock) -> int:
        # HostOS hands back ONE Sock object per connection incarnation
        # (keyed by slot+generation), so object identity is the stable
        # mapping — recycled slots and late post-close wakes both
        # resolve to the right handle.
        h = self._handle_of.get(id(sock))
        if h is None:
            h = self._new_handle(sock)
        return h

    def _wake(self, os, reason, a=0, b=0, c=0):
        self._os = os
        self.lib.plugin_on_wake(self.state, None,
                                ctypes.byref(self._api),
                                reason, a, b, c)

    # --- HostedApp surface ---
    def on_start(self, os):
        self._wake(os, 0)

    def on_timer(self, os, tag):
        self._wake(os, 1, a=tag)

    def on_dgram(self, os, sock, src, sport, nbytes, aux):
        self._wake(os, 2, a=self._handle_of_slot(sock), b=src,
                   c=(aux << 32) | (nbytes & 0xFFFFFFFF))

    def on_connected(self, os, sock, **_identity):
        self._wake(os, 3, a=self._handle_of_slot(sock))

    def on_eof(self, os, sock):
        self._wake(os, 4, a=self._handle_of_slot(sock))

    def on_accept(self, os, sock, tag, dport=0, peer=(0, 0)):
        self._wake(os, 5, a=self._handle_of_slot(sock), b=tag)

    def on_sent(self, os, sock):
        self._wake(os, 6, a=self._handle_of_slot(sock))


def register_c_plugin(name: str, c_or_so_path: str):
    """Register a native plugin under ``hosted:<name>``."""
    path = c_or_so_path
    if path.endswith((".c", ".cpp", ".cc")):
        path = build_plugin(path)
    register(name, lambda args: CPluginApp(path, args))
