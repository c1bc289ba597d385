"""S3 gateway — S3-compatible REST API over the filer, after upstream's
weed/s3api/.

  auth.py   — AWS Signature V4 verification + identity/action access
              control (s3api/auth_credentials.go, auth_signature_v4.go)
  policy.py — bucket policies, evaluated before identity grants
  server.py — S3ApiServer: bucket/object/multipart REST handlers
              (s3api/s3api_server.go, s3api_bucket_handlers.go,
              s3api_object_handlers.go, filer_multipart.go)

Buckets live under /buckets/<name> in the filer namespace, as upstream's
do. Object data flows through the filer HTTP API (which chunks to the
volume tier); metadata ops (listings, multipart assembly by chunk-list
splicing) go over the filer RPC service. The gateway runs no kernel: a
degraded object's chunks are rebuilt on the volume servers' card.
"""

from seaweedfs_tpu_torch.s3api.auth import Iam, Identity, sign_request

__all__ = ["Iam", "Identity", "sign_request", "S3ApiServer"]


def __getattr__(name):
    # the gateway stands on the filer client (and so grpc); the signer and
    # the verifier do not, and the tiering path imports them without it
    if name == "S3ApiServer":
        from seaweedfs_tpu_torch.s3api.server import S3ApiServer

        return S3ApiServer
    raise AttributeError(name)
