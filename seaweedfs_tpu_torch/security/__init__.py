"""Security (upstream's weed/security: guard.go, jwt.go): HMAC-SHA256
JWTs minted by the master on Assign and enforced by volume servers on
the write/delete data path; an optional separate read key; TLS for the
gRPC control plane and the HTTP data path in `security.tls`, which
imports grpc and is therefore not imported here."""

from seaweedfs_tpu_torch.security.guard import Guard
from seaweedfs_tpu_torch.security.jwt import decode_jwt, encode_jwt

__all__ = ["Guard", "encode_jwt", "decode_jwt"]
