# Copy of ceph_tpu/rados/auth.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""cephx-lite: ticket/rotating-key authentication + AES-GCM secure mode.

Role-equivalent of the reference's auth stack (reference src/auth/:
CephxKeyServer rotating secrets, CephxServiceTicket issue/verify;
src/msg/async/crypto_onwire.cc AES-GCM session security):

- The mon runs a ``KeyServer``: a small ring of ROTATING service secrets
  (current + previous, so tickets issued just before a rotation stay
  valid for one more period).  Entities authenticate to the mon with the
  bootstrap secret (the keyring role) and receive a TICKET: a
  service-secret-encrypted blob naming the entity and carrying a fresh
  SESSION KEY, plus the session key in the clear for the requester.
- OSDs hold the rotating secrets (fetched from the mon at boot, refreshed
  on rotation) in a ``TicketKeyring`` and validate presented tickets
  WITHOUT talking to the mon — the whole point of the ticket model: the
  auth server is not on the data path.
- Connections authenticated by ticket prove possession of the session key
  (HMAC over handshake nonces); with ``ms_secure_mode`` the session key
  also keys AES-GCM framing for everything after the handshake
  (``SecureStream``), so data frames are confidential and tamper-evident,
  not just crc-guarded.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Tuple

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:  # gated: hosts without `cryptography` still run
    # plaintext clusters; ticket sealing / ms_secure_mode raise on USE
    # (a missing crypto backend must never silently downgrade security)
    AESGCM = None


def _require_aesgcm():
    if AESGCM is None:
        raise RuntimeError(
            "the `cryptography` package is required for cephx tickets / "
            "ms_secure_mode but is not installed")

TICKET_TTL = 3600.0  # auth_service_ticket_ttl role


class KeyServer:
    """Mon-side rotating service secrets + ticket issuance (reference
    CephxKeyServer)."""

    def __init__(self, ttl: float = TICKET_TTL):
        self.ttl = ttl
        self.current_id = 1
        self.secrets: Dict[int, bytes] = {1: os.urandom(32)}

    def rotate(self) -> int:
        """Introduce a fresh service secret; keep only current+previous so
        a ticket sealed under a retired secret ages out after one period
        (the reference keeps a 3-slot window for clock skew)."""
        self.current_id += 1
        self.secrets[self.current_id] = os.urandom(32)
        for key_id in [k for k in self.secrets
                       if k < self.current_id - 1]:
            del self.secrets[key_id]
        return self.current_id

    def issue_ticket(self, entity: str, entity_type: str,
                     now: Optional[float] = None) -> Tuple[bytes, bytes]:
        """Returns (ticket_blob, session_key).  The blob can only be
        opened by holders of the rotating secret (OSDs); the session key
        goes back to the requester in the clear over its already-
        authenticated mon connection."""
        now = time.time() if now is None else now
        _require_aesgcm()
        session_key = os.urandom(32)
        body = json.dumps({
            "entity": entity,
            "type": entity_type,
            "session_key": session_key.hex(),
            "expires": now + self.ttl,
        }).encode()
        nonce = os.urandom(12)
        ct = AESGCM(self.secrets[self.current_id]).encrypt(nonce, body, None)
        blob = (self.current_id.to_bytes(4, "big") + nonce + ct)
        return blob, session_key

    def export_keys(self) -> Dict[int, str]:
        """Rotating secrets for distribution to OSDs (hex-encoded)."""
        return {k: v.hex() for k, v in self.secrets.items()}


class TicketKeyring:
    """Validator side: the rotating secrets an OSD holds (reference
    RotatingKeyRing)."""

    def __init__(self, keys: Optional[Dict[int, bytes]] = None):
        self.keys: Dict[int, bytes] = dict(keys or {})

    def load(self, exported: Dict[int, str]) -> None:
        self.keys = {int(k): bytes.fromhex(v) for k, v in exported.items()}

    def validate(self, blob: bytes,
                 now: Optional[float] = None) -> Optional[Dict]:
        """Open a ticket: returns {entity, type, session_key, expires} or
        None (unknown secret id, tampered, or expired)."""
        now = time.time() if now is None else now
        if len(blob) < 17:
            return None
        _require_aesgcm()
        key_id = int.from_bytes(blob[:4], "big")
        secret = self.keys.get(key_id)
        if secret is None:
            return None
        try:
            body = AESGCM(secret).decrypt(blob[4:16], blob[16:], None)
            t = json.loads(body)
        except Exception:
            return None
        if t.get("expires", 0) < now:
            return None
        t["session_key"] = bytes.fromhex(t["session_key"])
        return t


class SecureStream:
    """AES-GCM framing over an asyncio (reader, writer) pair (reference
    crypto_onwire.cc session security): every write becomes
    [4B length][12B nonce][ciphertext+tag]; reads decrypt and re-expose a
    byte stream via readexactly(), so the messenger's frame parser is
    unchanged.  Installed AFTER the plaintext handshake."""

    def __init__(self, reader, writer, key: bytes):
        _require_aesgcm()
        self._reader = reader
        self._writer = writer
        self._gcm = AESGCM(key)
        self._buf = bytearray()

    # -- writer surface ------------------------------------------------------

    def write(self, data: bytes) -> None:
        nonce = os.urandom(12)
        ct = self._gcm.encrypt(nonce, bytes(data), None)
        self._writer.write(len(ct).to_bytes(4, "big") + nonce + ct)

    def writelines(self, segments) -> None:
        # AES-GCM copies into the ciphertext anyway: scatter-gather
        # degrades to one join + one encrypted record (still one syscall)
        self.write(b"".join(bytes(s) for s in segments))

    async def drain(self) -> None:
        await self._writer.drain()

    def close(self) -> None:
        self._writer.close()

    async def wait_closed(self) -> None:
        await self._writer.wait_closed()

    def get_extra_info(self, *a, **kw):
        return self._writer.get_extra_info(*a, **kw)

    # -- reader surface ------------------------------------------------------

    async def readexactly(self, n: int) -> bytes:
        while len(self._buf) < n:
            hdr = await self._reader.readexactly(4)
            length = int.from_bytes(hdr, "big")
            nonce = await self._reader.readexactly(12)
            ct = await self._reader.readexactly(length)
            self._buf.extend(self._gcm.decrypt(nonce, ct, None))
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    async def readline(self) -> bytes:
        # only used if a handshake line straggles; decrypt-buffered search
        while b"\n" not in self._buf:
            hdr = await self._reader.readexactly(4)
            length = int.from_bytes(hdr, "big")
            nonce = await self._reader.readexactly(12)
            ct = await self._reader.readexactly(length)
            self._buf.extend(self._gcm.decrypt(nonce, ct, None))
        i = self._buf.index(b"\n") + 1
        out = bytes(self._buf[:i])
        del self._buf[:i]
        return out
