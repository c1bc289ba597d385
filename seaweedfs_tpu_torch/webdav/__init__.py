"""WebDAV gateway — mirror of weed/server/webdav_server.go (golang.org/x/
net/webdav backed by the filer).

Class-2 WebDAV on the filer namespace: OPTIONS, PROPFIND (Depth 0/1),
MKCOL, GET/HEAD/PUT/DELETE, MOVE, COPY, LOCK/UNLOCK (exclusive depth-0
write locks with timeout/refresh — what Finder/Windows/Office require
to mount read-write). Data flows through the filer HTTP API; namespace
ops over filer RPC.
"""

from seaweedfs_tpu_torch.webdav.server import WebDavServer

__all__ = ["WebDavServer"]
