"""Socket transport: TCP gossip + req/resp RPC, UDP discovery pings.

The port of `lighthouse_tpu/network/socket_net.py`.

Role of the reference's real network edge
(lighthouse_network/src/behaviour/mod.rs:148 gossipsub over TCP,
rpc/codec/ssz_snappy.rs length-prefixed ssz_snappy req/resp,
discovery/mod.rs discv5 UDP): bytes actually cross OS sockets between
processes. `SocketNet` exposes the SAME surface as the in-process
`GossipHub` (join/subscribe/publish/report) plus RPC client proxies with
the `RpcServer` method surface, so `BeaconNode` and `SyncManager` run
unchanged over either transport.

Wire format (all little-endian):
  frame   := [u32 len][u8 kind][body]
  HELLO   (1): JSON {node_id, topics}           — handshake + interests
  GOSSIP  (2): [u16 tlen][topic][payload]       — payload is ssz_snappy
  RPC_REQ (3): [u32 req_id][u8 mlen][method][ssz_snappy payload]
  RPC_RSP (4): [u32 req_id][u8 status][chunks]  — chunk := [u32 len][data]
  SUB     (5): JSON {topics}                    — interest update

Gossip propagation is MESH-based (gossipsub's GRAFT/PRUNE control plane,
behaviour/mod.rs:148): a per-topic mesh of target degree D is maintained
by a heartbeat (graft under-degree, prune over-degree), messages forward
to mesh peers only once the mesh has formed (flood-to-interested is the
bootstrap fallback below D_lo so delivery never stalls), with message-id
dedup; scores accumulate per peer and a banned peer's connection is
dropped and un-meshed (peer_manager ban semantics).

UDP discovery: PING {node_id, tcp_port} answered by PONG {node_id,
tcp_port, known: [[host, tcp, udp], ...]} — and `discover` walks the
known-lists breadth-first over MULTIPLE hops (the discv5
FINDNODE/NODES iteration, discovery/mod.rs), so a node knowing only a
bootstrap address learns the whole reachable topology.
"""

import random

import json
import socket
import struct
import threading
import time

from lighthouse_tpu_torch.common.locks import TimedLock
from lighthouse_tpu_torch.common.logging import TimeLatch, get_logger

from lighthouse_tpu_torch.network.gossip import (
    BAN_THRESHOLD,
    GOSSIP_MAX_SIZE,
    message_id,
)
from lighthouse_tpu_torch.network.rpc import (
    BlobSidecarsByRangeRequest,
    BlobSidecarsByRootRequest,
    BlocksByRangeRequest,
    DataColumnSidecarsByRootRequest,
    Goodbye,
    MetaData,
    Ping,
    RateLimitExceeded,
    RpcError,
    StatusMessage,
)

# wire status codes for RPC responses: 0 ok, 1 server error, 2 is used
# client-side for timeouts, 3 rate-limited. 3 must survive the wire as
# a TYPED RateLimitExceeded — the sync manager treats "you are over
# budget" (rotate penalty-free) very differently from "server error"
# (downscore), and flattening it would punish honest servers for the
# client's own polling.
RPC_STATUS_RATE_LIMITED = 3
from lighthouse_tpu_torch.network.snappy_codec import (
    frame_compress,
    frame_decompress,
)

_LOG = get_logger("socket_net")

KIND_HELLO = 1
KIND_GOSSIP = 2
KIND_RPC_REQ = 3
KIND_RPC_RSP = 4
KIND_SUB = 5
KIND_GRAFT = 6
KIND_PRUNE = 7

# gossipsub mesh parameters (behaviour/mod.rs:148 config: D/D_lo/D_hi)
MESH_D = 4
MESH_D_LO = 2
MESH_D_HI = 8
HEARTBEAT_INTERVAL = 1.0

# Dedup-cache generation size: at mainnet gossip rates (~tens of msgs/s)
# one generation covers several minutes — comfortably past the reference
# duplicate-cache TTL — while bounding the cache at 2 generations.
SEEN_CACHE_PER_GENERATION = 65_536

FORK_ORDER = ["phase0", "altair", "bellatrix"]


def _send_frame(sock, lock, kind: int, body: bytes):
    frame = struct.pack("<IB", len(body) + 1, kind) + body
    with lock:
        sock.sendall(frame)


def _recv_exact(sock, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class _PeerConn:
    def __init__(self, sock, node_id=None):
        self.sock = sock
        self.node_id = node_id
        self.topics: set[str] = set()
        self.score = 0.0
        self.lock = TimedLock("socket_net.peer_send")
        self.alive = True
        self.listen_port = None
        self.udp_port = None

    def close(self):
        self.alive = False
        try:
            self.sock.close()
        except OSError:
            pass


class RpcClientProxy:
    """RpcServer-shaped methods over the socket (the reference's
    outbound substream half of rpc/handler.rs)."""

    def __init__(self, net, peer_id: str, timeout: float = 10.0):
        self.net = net
        self.peer_id = peer_id
        self.timeout = timeout

    def _call(self, method: str, payload: bytes):
        return self.net._rpc_call(
            self.peer_id, method, payload, self.timeout
        )

    def status(self, caller: str) -> StatusMessage:
        chunks = self._call("status", b"")
        return StatusMessage.decode(frame_decompress(chunks[0]))

    def ping(self, caller: str, data: int) -> int:
        chunks = self._call("ping", frame_compress(Ping(data=data).to_bytes()))
        return Ping.decode(frame_decompress(chunks[0])).data

    def metadata(self, caller: str) -> MetaData:
        chunks = self._call("metadata", b"")
        return MetaData.decode(frame_decompress(chunks[0]))

    def blocks_by_range(self, caller: str, req: BlocksByRangeRequest):
        chunks = self._call(
            "blocks_by_range", frame_compress(req.to_bytes())
        )
        return [self.net._decode_block(c) for c in chunks]

    def blocks_by_root(self, caller: str, roots):
        payload = frame_compress(b"".join(bytes(r) for r in roots))
        chunks = self._call("blocks_by_root", payload)
        return [self.net._decode_block(c) for c in chunks]

    def goodbye(self, caller: str, reason: int = 0):
        self._call(
            "goodbye", frame_compress(Goodbye(reason=reason).to_bytes())
        )

    def blob_sidecars_by_range(self, caller: str, req):
        chunks = self._call(
            "blob_sidecars_by_range", frame_compress(req.to_bytes())
        )
        return [
            self.net.t.BlobSidecar.decode(frame_decompress(c))
            for c in chunks
        ]

    def blob_sidecars_by_root(self, caller: str, identifiers):
        req = BlobSidecarsByRootRequest(identifiers=list(identifiers))
        chunks = self._call(
            "blob_sidecars_by_root", frame_compress(req.to_bytes())
        )
        return [
            self.net.t.BlobSidecar.decode(frame_decompress(c))
            for c in chunks
        ]

    def data_column_sidecars_by_root(self, caller: str, identifiers):
        req = DataColumnSidecarsByRootRequest(
            identifiers=list(identifiers)
        )
        chunks = self._call(
            "data_column_sidecars_by_root",
            frame_compress(req.to_bytes()),
        )
        return [
            self.net.t.DataColumnSidecar.decode(frame_decompress(c))
            for c in chunks
        ]


class SocketNet:
    def __init__(
        self,
        node_id: str,
        types,
        spec,
        host: str = "127.0.0.1",
        rpc_server=None,
        on_peer_connected=None,
        on_peer_disconnected=None,
        forward_gate=None,
    ):
        """`on_peer_disconnected` fires when a peer's connection
        drops for ANY reason (read EOF, send failure, ban), so the sync
        manager's peer table cannot hold a dead proxy forever."""
        self.node_id = node_id
        self.t = types
        self.spec = spec
        self.host = host
        self.rpc_server = rpc_server
        self.on_peer_connected = on_peer_connected
        self.on_peer_disconnected = on_peer_disconnected
        # gossipsub propagation gating (behaviour validation mode): a
        # message failing the node's CHEAP structural validation is
        # delivered locally (for scoring) but NEVER forwarded — invalid
        # spam must not ride honest nodes deeper into the mesh, and the
        # penalty must land on the ORIGINAL sender, not on whichever
        # honest forwarder's frame won a thread race. The gate returns
        # (forward, decoded); `decoded` rides into the local delivery
        # so gate + deliver share ONE decode per message.
        self.forward_gate = forward_gate
        self.deliver = None  # set by join()
        self.local_topics: set[str] = set()
        self.peers: dict[str, _PeerConn] = {}
        # Gossip message-id dedup: two rotating generations so the cache
        # is bounded for the life of the process (the reference's
        # gossipsub duplicate cache is time-bounded; size-bounded
        # rotation gives the same no-leak property without a timer
        # thread). Membership = either generation; rotation drops ids
        # older than one full generation.
        self._seen: set[bytes] = set()
        self._seen_prev: set[bytes] = set()
        self._seen_lock = TimedLock("socket_net.seen")
        self._pending: dict[int, tuple[threading.Event, list]] = {}
        self._req_id = 0
        self._req_lock = TimedLock("socket_net.rpc_req")
        self._stopping = False
        self._heartbeat_latch = TimeLatch(30.0)
        # per-topic gossip mesh (gossipsub GRAFT/PRUNE control plane)
        self._mesh: dict[str, set[str]] = {}
        self._mesh_lock = TimedLock("socket_net.mesh")
        self._rng = random.Random(node_id)

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(
            socket.SOL_SOCKET, socket.SO_REUSEADDR, 1
        )
        self._listener.bind((host, 0))
        self._listener.listen(16)
        self.tcp_port = self._listener.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True).start()

        # UDP discovery endpoint
        self._udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._udp.bind((host, 0))
        self.udp_port = self._udp.getsockname()[1]
        threading.Thread(target=self._udp_loop, daemon=True).start()
        threading.Thread(target=self._heartbeat_loop, daemon=True).start()

    # -------------------------------------------------- GossipHub surface

    def join(self, node_id: str, deliver):
        self.deliver = deliver
        return self

    def subscribe(self, node_id: str, topic_str: str):
        self.local_topics.add(topic_str)
        body = json.dumps({"topics": [topic_str]}).encode()
        for conn in list(self.peers.values()):
            try:
                _send_frame(conn.sock, conn.lock, KIND_SUB, body)
            except OSError:
                self._drop(conn)

    def unsubscribe(self, node_id: str, topic_str: str):
        self.local_topics.discard(topic_str)

    def publish(self, from_peer: str, topic_str: str, data: bytes) -> int:
        if len(data) > GOSSIP_MAX_SIZE:
            return 0
        mid = message_id(topic_str.encode() + data)
        if self._seen_check_and_add(mid):
            return 0
        return self._fanout(topic_str, data, exclude=None)

    def _seen_check_and_add(self, mid: bytes) -> bool:
        """True if `mid` was already seen; otherwise records it and
        rotates the generations when the current one fills."""
        with self._seen_lock:
            if mid in self._seen or mid in self._seen_prev:
                return True
            self._seen.add(mid)
            if len(self._seen) >= SEEN_CACHE_PER_GENERATION:
                self._seen_prev = self._seen
                self._seen = set()
            return False

    def report(self, peer_id: str, delta: float):
        conn = self.peers.get(peer_id)
        if conn is None:
            return
        conn.score += delta
        if conn.score <= BAN_THRESHOLD:
            self._drop(conn)  # ban == disconnect (peer_manager)

    # ------------------------------------------------------------- dialing

    def connect(self, host: str, port: int):
        """Dial a peer's TCP listener; returns its node_id."""
        sock = socket.create_connection((host, port), timeout=10)
        conn = _PeerConn(sock)
        self._handshake_out(conn)
        threading.Thread(
            target=self._read_loop, args=(conn,), daemon=True
        ).start()
        return conn.node_id

    def rpc_client(self, peer_id: str) -> RpcClientProxy:
        return RpcClientProxy(self, peer_id)

    def _udp_ping(self, host: str, udp_port: int):
        """One PING/PONG exchange; returns the parsed pong or None."""
        ping = json.dumps(
            {
                "op": "ping",
                "node_id": self.node_id,
                "tcp_port": self.tcp_port,
                "udp_port": self.udp_port,
            }
        ).encode()
        # a throwaway socket: the bound listener's recvfrom loop would
        # race us for the pong datagram
        probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        probe.settimeout(5.0)
        try:
            probe.sendto(ping, (host, udp_port))
            data, _addr = probe.recvfrom(65536)
            return json.loads(data)
        except (OSError, ValueError):
            return None
        finally:
            probe.close()

    def discover(
        self, host: str, udp_port: int, max_hops: int = 3,
        max_peers: int = 32,
    ):
        """Breadth-first multi-hop discovery from a bootstrap address
        (discv5's iterative FINDNODE/NODES, discovery/mod.rs): ping the
        frontier, learn each pong's known peers, dial every new TCP
        listener, and keep walking until the topology is exhausted,
        `max_hops` rings out, or `max_peers` connections."""
        connected = []
        seen_udp = {(host, udp_port)}
        frontier = [(host, udp_port)]
        # never re-dial peers we already hold a connection to: a
        # duplicate HELLO would replace the peers entry and orphan the
        # old socket + its reader thread
        dialed_tcp = {
            (self.host, c.listen_port)
            for c in list(self.peers.values())
            if c.alive and c.listen_port
        }
        for _hop in range(max_hops):
            if not frontier or len(connected) >= max_peers:
                break
            next_frontier = []
            for ping_host, ping_udp in frontier:
                pong = self._udp_ping(ping_host, ping_udp)
                if pong is None:
                    continue
                entries = [[ping_host, pong.get("tcp_port"), None]]
                for entry in pong.get("known", []):
                    # tolerate both [host, tcp] and [host, tcp, udp]
                    e = list(entry) + [None] * (3 - len(entry))
                    entries.append(e[:3])
                for peer_host, tcp_port, peer_udp in entries:
                    if tcp_port is None:
                        continue
                    key = (peer_host, tcp_port)
                    if key not in dialed_tcp and tcp_port != self.tcp_port:
                        dialed_tcp.add(key)
                        if len(connected) < max_peers:
                            try:
                                connected.append(
                                    self.connect(peer_host, tcp_port)
                                )
                            except OSError:
                                pass
                    if peer_udp and (peer_host, peer_udp) not in seen_udp:
                        seen_udp.add((peer_host, peer_udp))
                        next_frontier.append((peer_host, peer_udp))
            frontier = next_frontier
        return connected

    def close(self):
        self._stopping = True
        for conn in list(self.peers.values()):
            conn.close()
        try:
            self._listener.close()
            self._udp.close()
        except OSError:
            pass

    # ----------------------------------------------------------- internals

    def _hello_body(self) -> bytes:
        return json.dumps(
            {
                "node_id": self.node_id,
                "topics": sorted(self.local_topics),
                "tcp_port": self.tcp_port,
                "udp_port": self.udp_port,
            }
        ).encode()

    def _handshake_out(self, conn: _PeerConn):
        _send_frame(conn.sock, conn.lock, KIND_HELLO, self._hello_body())
        frame = self._read_frame(conn)
        if frame is None or frame[0] != KIND_HELLO:
            conn.close()
            raise OSError("handshake failed")
        self._apply_hello(conn, frame[1])

    def _apply_hello(self, conn: _PeerConn, body: bytes):
        doc = json.loads(body)
        conn.node_id = doc["node_id"]
        conn.topics.update(doc.get("topics", []))
        conn.listen_port = doc.get("tcp_port")
        conn.udp_port = doc.get("udp_port")
        self.peers[conn.node_id] = conn
        if self.on_peer_connected is not None:
            self.on_peer_connected(conn.node_id)

    def _accept_loop(self):
        while not self._stopping:
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return
            conn = _PeerConn(sock)
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: _PeerConn):
        frame = self._read_frame(conn)
        if frame is None or frame[0] != KIND_HELLO:
            conn.close()
            return
        self._apply_hello(conn, frame[1])
        _send_frame(conn.sock, conn.lock, KIND_HELLO, self._hello_body())
        self._read_loop(conn)

    def _read_frame(self, conn: _PeerConn):
        header = _recv_exact(conn.sock, 5)
        if header is None:
            return None
        length, kind = struct.unpack("<IB", header)
        body = _recv_exact(conn.sock, length - 1)
        if body is None:
            return None
        return kind, body

    def _read_loop(self, conn: _PeerConn):
        try:
            while conn.alive:
                frame = self._read_frame(conn)
                if frame is None:
                    break
                self._handle_frame(conn, *frame)
        except OSError:
            pass
        finally:
            self._drop(conn)

    def _handle_frame(self, conn: _PeerConn, kind: int, body: bytes):
        if kind == KIND_GOSSIP:
            (tlen,) = struct.unpack_from("<H", body)
            topic_str = body[2 : 2 + tlen].decode()
            payload = body[2 + tlen :]
            mid = message_id(topic_str.encode() + payload)
            if self._seen_check_and_add(mid):
                return
            # the gate runs FIRST and returns (forward, decoded): an
            # invalid message is not propagated (gossipsub's validate-
            # before-forward contract), and whatever the gate decoded
            # is threaded into this message's local delivery — each
            # message is decoded exactly once per node
            forward, decoded = True, None
            if self.forward_gate is not None:
                forward, decoded = self.forward_gate(topic_str, payload)
            if topic_str in self.local_topics and self.deliver is not None:
                if decoded is None:
                    # legacy 3-arg deliver callbacks (tests, external
                    # consumers) keep working when the gate decoded
                    # nothing — the common case for every non-sidecar
                    # topic
                    self.deliver(topic_str, payload, conn.node_id)
                else:
                    self.deliver(
                        topic_str, payload, conn.node_id, decoded
                    )
            if forward:
                self._fanout(
                    topic_str, payload, exclude=conn.node_id
                )
        elif kind == KIND_SUB:
            conn.topics.update(json.loads(body).get("topics", []))
        elif kind == KIND_GRAFT:
            self._handle_graft(conn, json.loads(body).get("topics", []))
        elif kind == KIND_PRUNE:
            self._handle_prune(conn, json.loads(body).get("topics", []))
        elif kind == KIND_RPC_REQ:
            threading.Thread(
                target=self._serve_rpc,
                args=(conn, body),
                daemon=True,
            ).start()
        elif kind == KIND_RPC_RSP:
            (req_id,) = struct.unpack_from("<I", body)
            status = body[4]
            chunks, pos = [], 5
            while pos + 4 <= len(body):
                (clen,) = struct.unpack_from("<I", body, pos)
                chunks.append(body[pos + 4 : pos + 4 + clen])
                pos += 4 + clen
            waiter = self._pending.pop(req_id, None)
            if waiter is not None:
                event, out = waiter
                out.append((status, chunks))
                event.set()

    def _fanout(self, topic_str: str, payload: bytes, exclude) -> int:
        body = (
            struct.pack("<H", len(topic_str))
            + topic_str.encode()
            + payload
        )
        with self._mesh_lock:
            mesh = set(self._mesh.get(topic_str, ()))
        mesh.discard(exclude)
        use_mesh = len(mesh) >= MESH_D_LO
        sent = 0
        for conn in list(self.peers.values()):
            if not conn.alive or conn.node_id == exclude:
                continue
            if topic_str not in conn.topics:
                continue
            # mesh-formed: forward along mesh links only; pre-mesh
            # bootstrap: flood to every interested peer so delivery
            # never stalls while grafting catches up
            if use_mesh and conn.node_id not in mesh:
                continue
            try:
                _send_frame(conn.sock, conn.lock, KIND_GOSSIP, body)
                sent += 1
            except OSError:
                self._drop(conn)
        return sent

    # ------------------------------------------------------------ mesh

    def mesh_peers(self, topic_str: str) -> set:
        with self._mesh_lock:
            return set(self._mesh.get(topic_str, ()))

    def _heartbeat_loop(self):
        while not self._stopping:
            time.sleep(HEARTBEAT_INTERVAL)
            try:
                self._maintain_mesh()
            except Exception as e:
                # the heartbeat must survive transient peer churn —
                # visibly: a REPEATING failure here means the mesh is
                # not being maintained, so it warns (rate-latched)
                if self._heartbeat_latch.elapsed():
                    _LOG.warning(
                        "heartbeat mesh maintenance failing: %s", e
                    )

    def _maintain_mesh(self):
        """Gossipsub heartbeat: graft under-degree topics up toward D,
        prune over-degree ones down from D_hi."""
        for topic in list(self.local_topics):
            interested = {
                pid
                for pid, c in list(self.peers.items())
                if c.alive and topic in c.topics
            }
            graft_to, prune_from = [], []
            with self._mesh_lock:
                mesh = self._mesh.setdefault(topic, set())
                mesh &= interested  # forget dead/unsubscribed peers
                if len(mesh) < MESH_D:
                    candidates = list(interested - mesh)
                    self._rng.shuffle(candidates)
                    take = candidates[: MESH_D - len(mesh)]
                    mesh.update(take)
                    graft_to = take
                elif len(mesh) > MESH_D_HI:
                    extras = list(mesh)
                    self._rng.shuffle(extras)
                    prune_from = extras[: len(mesh) - MESH_D]
                    mesh.difference_update(prune_from)
            for pid in graft_to:
                self._send_control(pid, KIND_GRAFT, topic)
            for pid in prune_from:
                self._send_control(pid, KIND_PRUNE, topic)

    def _send_control(self, peer_id: str, kind: int, topic: str):
        conn = self.peers.get(peer_id)
        if conn is None or not conn.alive:
            return
        try:
            _send_frame(
                conn.sock,
                conn.lock,
                kind,
                json.dumps({"topics": [topic]}).encode(),
            )
        except OSError:
            self._drop(conn)

    def _handle_graft(self, conn: _PeerConn, topics):
        for topic in topics:
            if topic not in self.local_topics:
                self._send_control(conn.node_id, KIND_PRUNE, topic)
                continue
            with self._mesh_lock:
                mesh = self._mesh.setdefault(topic, set())
                if len(mesh) >= MESH_D_HI and conn.node_id not in mesh:
                    over = True
                else:
                    mesh.add(conn.node_id)
                    over = False
            if over:
                self._send_control(conn.node_id, KIND_PRUNE, topic)

    def _handle_prune(self, conn: _PeerConn, topics):
        with self._mesh_lock:
            for topic in topics:
                self._mesh.get(topic, set()).discard(conn.node_id)

    # ---------------------------------------------------------------- rpc

    def _rpc_call(self, peer_id, method, payload, timeout):
        conn = self.peers.get(peer_id)
        if conn is None or not conn.alive:
            raise RpcError(2, f"peer {peer_id} not connected")
        with self._req_lock:
            self._req_id += 1
            req_id = self._req_id
        event, out = threading.Event(), []
        self._pending[req_id] = (event, out)
        body = (
            struct.pack("<IB", req_id, len(method))
            + method.encode()
            + payload
        )
        _send_frame(conn.sock, conn.lock, KIND_RPC_REQ, body)
        if not event.wait(timeout):
            self._pending.pop(req_id, None)
            raise RpcError(2, f"rpc {method} timed out")
        status, chunks = out[0]
        if status == RPC_STATUS_RATE_LIMITED:
            raise RateLimitExceeded
        if status != 0:
            raise RpcError(status, chunks[0].decode() if chunks else "")
        return chunks

    def _serve_rpc(self, conn: _PeerConn, body: bytes):
        (req_id,) = struct.unpack_from("<I", body)
        mlen = body[4]
        method = body[5 : 5 + mlen].decode()
        payload = body[5 + mlen :]
        try:
            chunks = self._dispatch_rpc(conn.node_id, method, payload)
            status = 0
        except RateLimitExceeded:
            status, chunks = RPC_STATUS_RATE_LIMITED, [b"rate limited"]
        except RpcError as e:
            status, chunks = e.args[0] or 1, [str(e.args[1]).encode()]
        except Exception as e:
            status, chunks = 1, [str(e).encode()]
        resp = struct.pack("<IB", req_id, status) + b"".join(
            struct.pack("<I", len(c)) + c for c in chunks
        )
        try:
            _send_frame(conn.sock, conn.lock, KIND_RPC_RSP, resp)
        except OSError:
            self._drop(conn)

    def _dispatch_rpc(self, peer_id, method, payload):
        srv = self.rpc_server
        if srv is None:
            raise RpcError(1, "no rpc server")
        if method == "status":
            return [frame_compress(srv.status(peer_id).to_bytes())]
        if method == "ping":
            data = Ping.decode(frame_decompress(payload)).data
            return [
                frame_compress(
                    Ping(data=srv.ping(peer_id, data)).to_bytes()
                )
            ]
        if method == "metadata":
            return [frame_compress(srv.metadata(peer_id).to_bytes())]
        if method == "blocks_by_range":
            req = BlocksByRangeRequest.decode(frame_decompress(payload))
            blocks = srv.blocks_by_range(peer_id, req)
            return [self._encode_block(b) for b in blocks]
        if method == "blocks_by_root":
            raw = frame_decompress(payload)
            roots = [raw[i : i + 32] for i in range(0, len(raw), 32)]
            blocks = srv.blocks_by_root(peer_id, roots)
            return [self._encode_block(b) for b in blocks]
        if method == "goodbye":
            reason = Goodbye.decode(frame_decompress(payload)).reason
            srv.goodbye(peer_id, int(reason))
            return []
        if method == "blob_sidecars_by_range":
            req = BlobSidecarsByRangeRequest.decode(
                frame_decompress(payload)
            )
            sidecars = srv.blob_sidecars_by_range(peer_id, req)
            return [frame_compress(sc.to_bytes()) for sc in sidecars]
        if method == "blob_sidecars_by_root":
            req = BlobSidecarsByRootRequest.decode(
                frame_decompress(payload)
            )
            sidecars = srv.blob_sidecars_by_root(
                peer_id, req.identifiers
            )
            return [frame_compress(sc.to_bytes()) for sc in sidecars]
        if method == "data_column_sidecars_by_root":
            req = DataColumnSidecarsByRootRequest.decode(
                frame_decompress(payload)
            )
            sidecars = srv.data_column_sidecars_by_root(
                peer_id, req.identifiers
            )
            return [frame_compress(sc.to_bytes()) for sc in sidecars]
        raise RpcError(1, f"unknown method {method}")

    def _encode_block(self, signed_block) -> bytes:
        fork = self.spec.fork_name_at_epoch(
            self.spec.slot_to_epoch(signed_block.message.slot)
        )
        return bytes([FORK_ORDER.index(fork)]) + frame_compress(
            signed_block.to_bytes()
        )

    def _decode_block(self, chunk: bytes):
        fork = FORK_ORDER[chunk[0]]
        cls = self.t.signed_block_classes[fork]
        return cls.decode(frame_decompress(chunk[1:]))

    def _drop(self, conn: _PeerConn):
        conn.close()
        if conn.node_id and self.peers.get(conn.node_id) is conn:
            del self.peers[conn.node_id]
            with self._mesh_lock:
                for mesh in self._mesh.values():
                    mesh.discard(conn.node_id)
            if self.on_peer_disconnected is not None:
                try:
                    self.on_peer_disconnected(conn.node_id)
                except Exception as e:
                    # the disconnect hook must not break the read loop
                    _LOG.warning(
                        "on_peer_disconnected(%s) failed: %s",
                        conn.node_id, e,
                    )

    # ---------------------------------------------------------- discovery

    def _udp_loop(self):
        while not self._stopping:
            try:
                data, addr = self._udp.recvfrom(65536)
            except OSError:
                return
            try:
                doc = json.loads(data)
            except ValueError:
                continue
            if doc.get("op") == "ping":
                # advertise peers by the LISTEN ports learned in HELLO
                # ([host, tcp, udp] — udp lets the pinger keep walking)
                known = [
                    [self.host, c.listen_port, c.udp_port]
                    for c in list(self.peers.values())
                    if c.alive and c.listen_port
                ]
                pong = json.dumps(
                    {
                        "op": "pong",
                        "node_id": self.node_id,
                        "tcp_port": self.tcp_port,
                        "known": known,
                    }
                ).encode()
                try:
                    self._udp.sendto(pong, addr)
                except OSError:
                    pass

