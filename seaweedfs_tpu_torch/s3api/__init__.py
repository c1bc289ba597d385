"""The S3 front, after upstream's weed/s3api/. Only the SigV4 client half
(auth.py: `sign_request`) is here so far, for the S3 remote-storage
vendor; the gateway (server.py), the verifier and IAM are still to port.
"""

from seaweedfs_tpu_torch.s3api.auth import sign_request

__all__ = ["sign_request"]
