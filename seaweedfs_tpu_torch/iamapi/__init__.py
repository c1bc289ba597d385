"""IAM API — mirror of weed/iamapi/: an AWS-IAM-query-compatible endpoint (form-encoded
Action=CreateUser/CreateAccessKey/...) that manages the S3 gateway's
identity set. Identities persist in the filer KV store under
`s3_identities` (the reference keeps its s3 config in the filer /etc
tree), so a restarted gateway reloads them.
"""

from seaweedfs_tpu_torch.iamapi.server import (
    IamApiServer,
    load_identities,
    save_identities,
)

__all__ = ["IamApiServer", "load_identities", "save_identities"]
