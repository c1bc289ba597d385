"""The port's WebDAV and IAM gateways: a twin of each of the 8 cases of
`tests/test_webdav_iam.py`, with the reference case's own steps and
assertions run on a port stack (master, one volume server on `Encoder(10,
4, device="cpu")`, filer, WebDAV and IAM on loopback); then cross-package
cases (at the end): one WebDAV and IAM request script through a
reference stack and a port stack gives the same statuses, IAM error codes
and PROPFIND bodies, and each front of the port sets TCP_NODELAY on its
accepted sockets."""

import contextlib
import random
import re
import socket
import types
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET

import pytest

from seaweedfs_tpu_torch.cluster.master import MasterServer
from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
from seaweedfs_tpu_torch.filer import FilerServer
from seaweedfs_tpu_torch.iamapi import IamApiServer, load_identities
from seaweedfs_tpu_torch.ops.rs_codec import Encoder
from seaweedfs_tpu_torch.s3api import Iam
from seaweedfs_tpu_torch.webdav import WebDavServer

import seaweedfs_tpu.iamapi.server as ref_iamserver
import seaweedfs_tpu.s3api.auth as ref_auth
import seaweedfs_tpu.webdav.server as ref_davserver
import seaweedfs_tpu_torch.iamapi.server as port_iamserver
import seaweedfs_tpu_torch.s3api.auth as port_auth
import seaweedfs_tpu_torch.webdav.server as port_davserver

from test_torch_cluster import stop_all
from test_torch_filer import PORT as PORT_FILER
from test_torch_filer import REF as REF_FILER


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("davstack")
    master = MasterServer(port=0, reap_interval=3600)
    master.start()
    (tmp / "vol").mkdir()
    vs = VolumeServer([str(tmp / "vol")], master.address, heartbeat_interval=0.4,
                      encoder=Encoder(10, 4, device="cpu"))
    vs.start()
    fs = FilerServer(master.address)
    fs.start()
    dav = WebDavServer(fs.url, fs.grpc_address)
    dav.start()
    iam = IamApiServer(fs.grpc_address, iam=Iam([]), bootstrap_token="boot-secret")
    iam.start()
    yield fs, dav, iam
    iam.stop()
    dav.stop()
    fs.stop()
    vs.stop()
    master.stop()


def _req(base, method, path, body=None, headers=None):
    req = urllib.request.Request(
        base + path, data=body, method=method, headers=headers or {}
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def test_webdav_lifecycle(stack):
    fs, dav, _ = stack
    base = f"http://{dav.url}"
    code, headers, _ = _req(base, "OPTIONS", "/")
    assert code == 200 and "PROPFIND" in headers["Allow"]
    # MKCOL + PUT + GET
    assert _req(base, "MKCOL", "/davdir")[0] == 201
    assert _req(base, "MKCOL", "/davdir")[0] == 405  # exists
    code, _, _ = _req(base, "PUT", "/davdir/note.txt", b"dav content",
                      {"Content-Type": "text/plain"})
    assert code == 201
    code, _, got = _req(base, "GET", "/davdir/note.txt")
    assert code == 200 and got == b"dav content"
    code, headers, _ = _req(base, "HEAD", "/davdir/note.txt")
    assert code == 200 and headers["Content-Length"] == "11"
    # PROPFIND depth 1 on the collection
    code, _, body = _req(base, "PROPFIND", "/davdir", headers={"Depth": "1"})
    assert code == 207
    ms = ET.fromstring(body)
    hrefs = [h.text for h in ms.findall(".//{DAV:}href")]
    assert "/davdir/" in hrefs and "/davdir/note.txt" in hrefs
    lengths = [e.text for e in ms.findall(".//{DAV:}getcontentlength")]
    assert "11" in lengths
    # COPY then MOVE
    code, _, _ = _req(base, "COPY", "/davdir/note.txt",
                      headers={"Destination": f"http://{dav.url}/davdir/copy.txt"})
    assert code == 201
    code, _, _ = _req(base, "MOVE", "/davdir/copy.txt",
                      headers={"Destination": f"http://{dav.url}/davdir/moved.txt"})
    assert code == 201
    assert _req(base, "GET", "/davdir/moved.txt")[2] == b"dav content"
    assert _req(base, "GET", "/davdir/copy.txt")[0] == 404
    # Overwrite: F refuses to clobber
    code, _, _ = _req(base, "MOVE", "/davdir/moved.txt",
                      headers={"Destination": f"http://{dav.url}/davdir/note.txt",
                               "Overwrite": "F"})
    assert code == 412
    # DELETE collection
    assert _req(base, "DELETE", "/davdir")[0] == 204
    assert _req(base, "PROPFIND", "/davdir")[0] == 404


def _iam_call(url, creds=None, token=None, **form):
    from seaweedfs_tpu_torch.s3api.auth import sign_request

    data = urllib.parse.urlencode(form).encode()
    headers = {}
    if creds:
        headers = sign_request(creds[0], creds[1], "POST", url, data, service="iam")
    if token:
        headers["x-seaweedfs-bootstrap-token"] = token
    req = urllib.request.Request(url, data=data, method="POST", headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_iam_user_and_key_lifecycle(stack):
    fs, _, iam = stack
    url = f"http://{iam.url}/"
    ns = "{https://iam.amazonaws.com/doc/2010-05-08/}"
    # fresh cluster: anonymous calls are rejected outright — bootstrap
    # needs the pre-shared token (first-to-the-port must not mint Admin)
    code, _ = _iam_call(url, Action="CreateUser", UserName="eve")
    assert code == 403
    code, _ = _iam_call(url, token="wrong-token", Action="CreateUser", UserName="eve")
    assert code == 403
    boot = "boot-secret"
    # AWS-natural order: CreateUser → CreateAccessKey → PutUserPolicy.
    # The key exists with empty actions mid-sequence; the token gate must
    # stay open until a credentialed ADMIN exists, or the API self-locks.
    code, _ = _iam_call(url, token=boot, Action="CreateUser", UserName="root")
    assert code == 200
    code, body = _iam_call(url, token=boot, Action="CreateAccessKey", UserName="root")
    assert code == 200
    # malformed policy documents get 400, not a crashed handler thread
    for bad in ('[]', '"x"', '{"Statement": ["x"]}', '{"Statement": 3}'):
        code, _ = _iam_call(url, token=boot, Action="PutUserPolicy",
                            UserName="root", PolicyDocument=bad)
        assert code == 400, bad
    code, _ = _iam_call(url, token=boot, Action="PutUserPolicy", UserName="root",
                        PolicyDocument='{"Statement": [{"Effect": "Allow", '
                                       '"Action": "s3:*", "Resource": "*"}]}')
    assert code == 200
    root_el = ET.fromstring(body)
    admin = (root_el.find(f".//{ns}AccessKeyId").text,
             root_el.find(f".//{ns}SecretAccessKey").text)
    # the first minted key locks the API: unsigned mutations now 403
    code, _ = _iam_call(url, Action="CreateUser", UserName="eve")
    assert code == 403
    code, body = _iam_call(url, admin, Action="CreateUser", UserName="alice")
    assert code == 200 and b"alice" in body
    code, body = _iam_call(url, admin, Action="CreateAccessKey", UserName="alice")
    assert code == 200
    doc = ET.fromstring(body)
    ak = doc.find(f".//{ns}AccessKeyId").text
    sk = doc.find(f".//{ns}SecretAccessKey").text
    assert ak and sk
    # policy -> action mapping
    policy = (
        '{"Statement": [{"Effect": "Allow", "Action": ["s3:GetObject", '
        '"s3:ListBucket"], "Resource": "arn:aws:s3:::mybucket/*"}]}'
    )
    code, _ = _iam_call(url, admin, Action="PutUserPolicy", UserName="alice",
                        PolicyDocument=policy)
    assert code == 200
    ident = iam.iam.lookup(ak)
    assert ident is not None
    assert ident.actions == ["List:mybucket", "Read:mybucket"]
    assert ident.can_do("Read", "mybucket") and not ident.can_do("Read", "other")
    # a valid signature without Admin privileges is still rejected
    code, _ = _iam_call(url, (ak, sk), Action="CreateUser", UserName="mallory")
    assert code == 403
    # identities persisted to filer kv: reload sees alice
    from seaweedfs_tpu_torch.filer.client import FilerClient

    with FilerClient(fs.grpc_address) as fc:
        loaded = load_identities(fc)
    assert loaded is not None and loaded.lookup(ak) is not None
    # list/get/delete
    code, body = _iam_call(url, admin, Action="ListUsers")
    assert b"alice" in body
    code, _ = _iam_call(url, admin, Action="DeleteAccessKey", AccessKeyId=ak)
    assert code == 200
    code, _ = _iam_call(url, admin, Action="DeleteUser", UserName="alice")
    assert code == 200
    code, _ = _iam_call(url, admin, Action="GetUser", UserName="alice")
    assert code == 404
    code, _ = _iam_call(url, admin, Action="BogusAction")
    assert code == 400
    # the last credentialed admin cannot be revoked/deleted/demoted — any
    # of those would lock the IAM API (key exists, bootstrap gate closed)
    code, _ = _iam_call(url, admin, Action="DeleteAccessKey", AccessKeyId=admin[0])
    assert code == 409
    code, _ = _iam_call(url, admin, Action="DeleteUser", UserName="root")
    assert code == 409
    code, _ = _iam_call(url, admin, Action="PutUserPolicy", UserName="root",
                        PolicyDocument='{"Statement": [{"Effect": "Allow", '
                                       '"Action": "s3:GetObject", "Resource": "*"}]}')
    assert code == 409
    # a signature scoped for service=s3 must not verify on the IAM endpoint
    from seaweedfs_tpu_torch.s3api.auth import sign_request as _sr

    data = urllib.parse.urlencode({"Action": "ListUsers"}).encode()
    h = _sr(admin[0], admin[1], "POST", url, data, service="s3")
    req = urllib.request.Request(url, data=data, method="POST", headers=h)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            code = r.status
    except urllib.error.HTTPError as e:
        code = e.code
    assert code == 403

def test_webdav_class2_locks(stack):
    """RFC 4918 class-2 exclusive write locks: LOCK grants a token, writes
    without it 423, writes with it pass, refresh extends, UNLOCK frees."""
    fs, dav, _ = stack
    base = f"http://{dav.url}"
    _req(base, "PUT", "/locked.txt", b"v1")

    lockinfo = (
        b'<?xml version="1.0"?><D:lockinfo xmlns:D="DAV:">'
        b"<D:lockscope><D:exclusive/></D:lockscope>"
        b"<D:locktype><D:write/></D:locktype>"
        b"<D:owner>alice</D:owner></D:lockinfo>"
    )
    code, headers, body = _req(
        base, "LOCK", "/locked.txt", lockinfo, {"Timeout": "Second-60"}
    )
    assert code == 200, body
    token = headers["Lock-Token"].strip("<>")
    assert token.startswith("opaquelocktoken:")
    assert b"lockdiscovery" in body and b"alice" in body

    # second client cannot lock or write
    code, _, _ = _req(base, "LOCK", "/locked.txt", lockinfo)
    assert code == 423
    code, _, _ = _req(base, "PUT", "/locked.txt", b"intruder")
    assert code == 423
    code, _, _ = _req(base, "DELETE", "/locked.txt")
    assert code == 423
    code, _, _ = _req(
        base, "MOVE", "/locked.txt", None,
        {"Destination": f"http://{dav.url}/stolen.txt"},
    )
    assert code == 423

    # the holder writes fine with If: (<token>)
    code, _, _ = _req(
        base, "PUT", "/locked.txt", b"v2", {"If": f"(<{token}>)"}
    )
    assert code == 201
    code, _, body = _req(base, "GET", "/locked.txt")
    assert code == 200 and body == b"v2"

    # refresh: LOCK with empty body + the token
    code, headers, _ = _req(
        base, "LOCK", "/locked.txt", None,
        {"If": f"(<{token}>)", "Timeout": "Second-120"},
    )
    assert code == 200
    assert headers["Lock-Token"].strip("<>") == token  # same lock, extended

    # unlock with the wrong token fails; right token frees the resource
    code, _, _ = _req(
        base, "UNLOCK", "/locked.txt", None,
        {"Lock-Token": "<opaquelocktoken:bogus>"},
    )
    assert code == 409
    code, _, _ = _req(
        base, "UNLOCK", "/locked.txt", None, {"Lock-Token": f"<{token}>"}
    )
    assert code == 204
    code, _, _ = _req(base, "PUT", "/locked.txt", b"free again")
    assert code == 201


def test_webdav_lock_expires(stack):
    fs, dav, _ = stack
    base = f"http://{dav.url}"
    _req(base, "PUT", "/expire.txt", b"x")
    code, headers, _ = _req(
        base, "LOCK", "/expire.txt",
        b'<?xml version="1.0"?><D:lockinfo xmlns:D="DAV:">'
        b"<D:lockscope><D:exclusive/></D:lockscope>"
        b"<D:locktype><D:write/></D:locktype></D:lockinfo>",
        {"Timeout": "Second-1"},
    )
    assert code == 200
    import time as _t

    _t.sleep(1.2)
    code, _, _ = _req(base, "PUT", "/expire.txt", b"after-expiry")
    assert code == 201, "expired lock must not block writers"


def test_webdav_locks_cleared_by_delete_and_move(stack):
    """RFC 4918: DELETE destroys the lock; MOVE leaves no stale lock at
    either path; COPY and MKCOL respect a locked destination."""
    fs, dav, _ = stack
    base = f"http://{dav.url}"
    lockinfo = (
        b'<?xml version="1.0"?><D:lockinfo xmlns:D="DAV:">'
        b"<D:lockscope><D:exclusive/></D:lockscope>"
        b"<D:locktype><D:write/></D:locktype></D:lockinfo>"
    )
    # DELETE destroys the lock
    _req(base, "PUT", "/gone.txt", b"x")
    code, headers, _ = _req(base, "LOCK", "/gone.txt", lockinfo)
    token = headers["Lock-Token"].strip("<>")
    code, _, _ = _req(base, "DELETE", "/gone.txt", None, {"If": f"(<{token}>)"})
    assert code == 204
    code, _, _ = _req(base, "PUT", "/gone.txt", b"fresh")  # no stale 423
    assert code == 201

    # MOVE leaves no stale lock at src
    _req(base, "PUT", "/mv-src.txt", b"x")
    code, headers, _ = _req(base, "LOCK", "/mv-src.txt", lockinfo)
    token = headers["Lock-Token"].strip("<>")
    code, _, _ = _req(
        base, "MOVE", "/mv-src.txt", None,
        {"Destination": f"http://{dav.url}/mv-dst.txt", "If": f"(<{token}>)"},
    )
    assert code in (201, 204)
    code, _, _ = _req(base, "PUT", "/mv-src.txt", b"new tenant")
    assert code == 201
    code, _, _ = _req(base, "PUT", "/mv-dst.txt", b"unlocked")
    assert code == 201

    # COPY over a locked destination 423s; MKCOL at a locked path 423s
    _req(base, "PUT", "/copy-src.txt", b"src")
    _req(base, "PUT", "/copy-dst.txt", b"dst")
    code, headers, _ = _req(base, "LOCK", "/copy-dst.txt", lockinfo)
    token = headers["Lock-Token"].strip("<>")
    code, _, _ = _req(
        base, "COPY", "/copy-src.txt", None,
        {"Destination": f"http://{dav.url}/copy-dst.txt"},
    )
    assert code == 423
    code, headers2, _ = _req(base, "LOCK", "/newdir", lockinfo)
    tok2 = headers2["Lock-Token"].strip("<>")
    code, _, _ = _req(base, "MKCOL", "/newdir")
    assert code == 423
    _req(base, "UNLOCK", "/copy-dst.txt", None, {"Lock-Token": f"<{token}>"})
    _req(base, "UNLOCK", "/newdir", None, {"Lock-Token": f"<{tok2}>"})


def test_webdav_collection_ops_honor_child_locks(stack):
    """DELETE/MOVE of a directory must 423 while a child is locked by
    someone else, and a completed delete clears the subtree's locks."""
    fs, dav, _ = stack
    base = f"http://{dav.url}"
    lockinfo = (
        b'<?xml version="1.0"?><D:lockinfo xmlns:D="DAV:">'
        b"<D:lockscope><D:exclusive/></D:lockscope>"
        b"<D:locktype><D:write/></D:locktype></D:lockinfo>"
    )
    _req(base, "MKCOL", "/tree")
    _req(base, "PUT", "/tree/child.txt", b"x")
    code, headers, _ = _req(base, "LOCK", "/tree/child.txt", lockinfo)
    token = headers["Lock-Token"].strip("<>")
    # tokenless collection delete/move is refused while the child is locked
    code, _, _ = _req(base, "DELETE", "/tree")
    assert code == 423
    code, _, _ = _req(
        base, "MOVE", "/tree", None, {"Destination": f"http://{dav.url}/tree2"}
    )
    assert code == 423
    # the lock holder may delete the whole tree; child locks die with it
    code, _, _ = _req(base, "DELETE", "/tree", None, {"If": f"(<{token}>)"})
    assert code == 204
    _req(base, "MKCOL", "/tree")
    code, _, _ = _req(base, "PUT", "/tree/child.txt", b"fresh")  # no stale 423
    assert code == 201


def test_webdav_collection_lock_protects_members(stack):
    """RFC 4918 §7: an exclusive write lock on a collection protects
    internal member creation/modification/removal from tokenless writes,
    while the holder's token covers the whole subtree."""
    fs, dav, _ = stack
    base = f"http://{dav.url}"
    lockinfo = (
        b'<?xml version="1.0"?><D:lockinfo xmlns:D="DAV:">'
        b"<D:lockscope><D:exclusive/></D:lockscope>"
        b"<D:locktype><D:write/></D:locktype></D:lockinfo>"
    )
    _req(base, "MKCOL", "/treelock")
    _req(base, "PUT", "/treelock/child.txt", b"v1")
    code, headers, _ = _req(base, "LOCK", "/treelock", lockinfo)
    assert code == 200
    token = headers["Lock-Token"].strip("<>")

    # tokenless member writes are blocked by the collection lock
    code, _, _ = _req(base, "PUT", "/treelock/child.txt", b"intruder")
    assert code == 423
    code, _, _ = _req(base, "PUT", "/treelock/new.txt", b"intruder")
    assert code == 423
    code, _, _ = _req(base, "DELETE", "/treelock/child.txt")
    assert code == 423
    code, _, body = _req(base, "GET", "/treelock/child.txt")
    assert code == 200 and body == b"v1"

    # the holder's token covers members
    code, _, _ = _req(
        base, "PUT", "/treelock/child.txt", b"v2", {"If": f"(<{token}>)"}
    )
    assert code == 201
    code, _, _ = _req(
        base, "UNLOCK", "/treelock", None, {"Lock-Token": f"<{token}>"}
    )
    assert code == 204
    code, _, _ = _req(base, "PUT", "/treelock/child.txt", b"v3")
    assert code == 201


def test_webdav_child_lock_cannot_tunnel_collection_lock(stack):
    """A client must not bypass an exclusive collection lock by taking its
    own lock on a child — conflicting LOCK grants are refused in both
    directions (ancestor and descendant)."""
    fs, dav, _ = stack
    base = f"http://{dav.url}"
    lockinfo = (
        b'<?xml version="1.0"?><D:lockinfo xmlns:D="DAV:">'
        b"<D:lockscope><D:exclusive/></D:lockscope>"
        b"<D:locktype><D:write/></D:locktype></D:lockinfo>"
    )
    _req(base, "MKCOL", "/lockcol")
    _req(base, "PUT", "/lockcol/f.txt", b"v1")
    code, headers, _ = _req(base, "LOCK", "/lockcol", lockinfo)
    assert code == 200
    token = headers["Lock-Token"].strip("<>")
    # child lock under a locked collection: refused
    code, _, _ = _req(base, "LOCK", "/lockcol/f.txt", lockinfo)
    assert code == 423
    code, _, _ = _req(
        base, "UNLOCK", "/lockcol", None, {"Lock-Token": f"<{token}>"}
    )
    assert code == 204
    # now the child lock grants; an ancestor lock is then refused
    code, headers, _ = _req(base, "LOCK", "/lockcol/f.txt", lockinfo)
    assert code == 200
    child_token = headers["Lock-Token"].strip("<>")
    code, _, _ = _req(base, "LOCK", "/lockcol", lockinfo)
    assert code == 423
    _req(base, "UNLOCK", "/lockcol/f.txt", None, {"Lock-Token": f"<{child_token}>"})


# -- across the packages --------------------------------------------------------------------
#
# One WebDAV and IAM request script through a reference stack and a port stack.
# WebDAV replies mask getlastmodified and creationdate (the filer's clock) and
# the opaquelocktoken uuids; the IAM side seeds both packages' `uuid` (request
# ids) and `secrets` (minted keys), so its bodies compare whole.


PKGS = {
    "ref": types.SimpleNamespace(name="ref", f=REF_FILER, auth=ref_auth, dav=ref_davserver,
                                 iam=ref_iamserver),
    "port": types.SimpleNamespace(name="port", f=PORT_FILER, auth=port_auth,
                                  dav=port_davserver, iam=port_iamserver),
}
_DAV_MASK = [(re.compile(rb"<(\w+:getlastmodified|\w+:creationdate)>[^<]*</\1>"), rb"<\1>*</\1>"),
             (re.compile(rb"opaquelocktoken:[0-9a-f-]+"), b"opaquelocktoken:*")]
LOCKINFO = (b'<?xml version="1.0"?><D:lockinfo xmlns:D="DAV:">'
            b"<D:lockscope><D:exclusive/></D:lockscope>"
            b"<D:locktype><D:write/></D:locktype>"
            b"<D:owner>alice</D:owner></D:lockinfo>")


@contextlib.contextmanager
def gateway_stack(p, root):
    """The reference case's stack for one package: a master, a volume
    server on the package's CPU encoder, a filer, WebDAV and IAM (no
    identities, bootstrap token "boot-secret")."""
    c = p.f.cluster
    master = c.MasterServer(port=0, reap_interval=3600)
    master._rng = random.Random(7)
    master.start()
    (root / "vol").mkdir()
    vs = c.VolumeServer([str(root / "vol")], master.address, heartbeat_interval=0.3,
                        encoder=c.encoder())
    vs.start()
    fs = p.f.FilerServer(master.address)
    fs.start()
    dav = p.dav.WebDavServer(fs.url, fs.grpc_address)
    dav.start()
    iam = p.iam.IamApiServer(fs.grpc_address, iam=p.auth.Iam([]), bootstrap_token="boot-secret")
    iam.start()
    try:
        yield dav, iam
    finally:
        stop_all([iam, dav, fs, vs, master])


def _dav_script(dav) -> list:
    base = f"http://{dav.url}"
    dest = lambda p: {"Destination": f"http://{dav.url}{p}"}  # noqa: E731
    out = []

    def r(method, path, body=None, headers=None):
        code, h, got = _req(base, method, path, body, headers)
        for rx, repl in _DAV_MASK:
            got = rx.sub(repl, got)
        kept = {k: h.get(k) for k in ("Allow", "DAV", "Content-Length", "Content-Type", "ETag")
                if h.get(k) is not None}
        if h.get("Lock-Token"):
            kept["Lock-Token"] = _DAV_MASK[1][0].sub(b"opaquelocktoken:*",
                                                     h["Lock-Token"].encode()).decode()
        out.append((method, path, code, kept, got.replace(dav.url.encode(), b"<dav>")))
        return code, h, got

    r("OPTIONS", "/")
    r("MKCOL", "/dx")
    r("MKCOL", "/dx")
    r("MKCOL", "/nope/deeper")
    r("PUT", "/dx/note.txt", b"dav content", {"Content-Type": "text/plain"})
    r("PUT", "/dx/sub/auto.txt", b"parent made")
    for i in range(4):
        r("PUT", f"/dx/f{i}.bin", bytes(range(i * 40, i * 40 + 100)))
    r("GET", "/dx/note.txt")
    r("HEAD", "/dx/note.txt")
    r("GET", "/dx/missing")
    r("PROPFIND", "/dx", headers={"Depth": "0"})
    r("PROPFIND", "/dx", headers={"Depth": "1"})
    r("PROPFIND", "/dx/note.txt")
    r("PROPFIND", "/", headers={"Depth": "1"})
    r("PROPPATCH", "/dx/note.txt",
      b'<?xml version="1.0"?><D:propertyupdate xmlns:D="DAV:"><D:set><D:prop>'
      b'<D:displayname>n</D:displayname></D:prop></D:set></D:propertyupdate>')
    r("COPY", "/dx/note.txt", headers=dest("/dx/copy.txt"))
    r("MOVE", "/dx/copy.txt", headers=dest("/dx/moved.txt"))
    r("MOVE", "/dx/moved.txt", headers={**dest("/dx/note.txt"), "Overwrite": "F"})
    r("COPY", "/dx/sub", headers=dest("/dx/sub2"))
    r("GET", "/dx/moved.txt")
    _, h, _ = r("LOCK", "/dx/note.txt", LOCKINFO, {"Timeout": "Second-60"})
    token = h["Lock-Token"].strip("<>")
    r("LOCK", "/dx/note.txt", LOCKINFO)
    r("PUT", "/dx/note.txt", b"intruder")
    r("DELETE", "/dx/note.txt")
    r("MOVE", "/dx", headers=dest("/dy"))
    r("PUT", "/dx/note.txt", b"v2", {"If": f"(<{token}>)"})
    r("LOCK", "/dx/note.txt", None, {"If": f"(<{token}>)", "Timeout": "Second-120"})
    r("UNLOCK", "/dx/note.txt", None, {"Lock-Token": "<opaquelocktoken:bogus>"})
    r("UNLOCK", "/dx/note.txt", None, {"Lock-Token": f"<{token}>"})
    r("GET", "/dx/note.txt")
    r("DELETE", "/dx/f3.bin")
    r("PROPFIND", "/dx", headers={"Depth": "1"})
    r("DELETE", "/dx")
    r("PROPFIND", "/dx")
    return out


def _seed_iam_ids(monkeypatch, p) -> None:
    """The package's IAM server draws request ids and keys from one seeded
    generator (restarted per package)."""
    rng = random.Random(17)
    monkeypatch.setattr(p.iam, "uuid", types.SimpleNamespace(
        uuid4=lambda: types.SimpleNamespace(hex=f"{rng.getrandbits(128):032x}")))
    monkeypatch.setattr(p.iam, "secrets", types.SimpleNamespace(
        token_hex=lambda n: f"{rng.getrandbits(8 * n):0{2 * n}x}",
        token_urlsafe=lambda n: f"{rng.getrandbits(8 * n):x}"))


def _iam_script(p, iam) -> list:
    url = f"http://{iam.url}/"
    out = []

    def r(creds=None, token=None, service="iam", **form):
        data = urllib.parse.urlencode(form).encode()
        headers = {}
        if creds:
            headers = p.auth.sign_request(creds[0], creds[1], "POST", url, data, service=service)
        if token:
            headers["x-seaweedfs-bootstrap-token"] = token
        req = urllib.request.Request(url, data=data, method="POST", headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                code, body = resp.status, resp.read()
        except urllib.error.HTTPError as e:
            code, body = e.code, e.read()
        out.append((form.get("Action"), code, body))
        return code, body

    boot = "boot-secret"
    r(Action="CreateUser", UserName="eve")
    r(token="wrong-token", Action="CreateUser", UserName="eve")
    r(token=boot, Action="CreateUser", UserName="root")
    r(token=boot, Action="CreateUser", UserName="root")
    _, body = r(token=boot, Action="CreateAccessKey", UserName="root")
    for bad in ('[]', '"x"', '{"Statement": ["x"]}', '{"Statement": 3}'):
        r(token=boot, Action="PutUserPolicy", UserName="root", PolicyDocument=bad)
    r(token=boot, Action="PutUserPolicy", UserName="root",
      PolicyDocument='{"Statement": [{"Effect": "Allow", "Action": "s3:*", "Resource": "*"}]}')
    ns = "{https://iam.amazonaws.com/doc/2010-05-08/}"
    doc = ET.fromstring(body)
    admin = (doc.find(f".//{ns}AccessKeyId").text, doc.find(f".//{ns}SecretAccessKey").text)
    r(Action="CreateUser", UserName="eve")
    r(admin, Action="CreateUser", UserName="loader")
    _, body = r(admin, Action="CreateAccessKey", UserName="loader")
    doc = ET.fromstring(body)
    loader = (doc.find(f".//{ns}AccessKeyId").text, doc.find(f".//{ns}SecretAccessKey").text)
    r(admin, Action="PutUserPolicy", UserName="loader", PolicyName="rw", PolicyDocument=(
        '{"Statement": [{"Effect": "Allow", "Action": ["s3:GetObject", "s3:PutObject", '
        '"s3:ListBucket"], "Resource": "arn:aws:s3:::s3warm/*"}]}'))
    r(admin, Action="GetUser", UserName="loader")
    r(admin, Action="GetUserPolicy", UserName="loader", PolicyName="rw")
    r(admin, Action="ListUsers")
    r(admin, Action="ListAccessKeys", UserName="loader")
    r(loader, Action="CreateUser", UserName="mallory")
    r(admin, service="s3", Action="ListUsers")
    r(admin, Action="DeleteAccessKey", AccessKeyId=loader[0])
    r(admin, Action="DeleteUser", UserName="loader")
    r(admin, Action="GetUser", UserName="loader")
    r(admin, Action="DeleteUser", UserName="nobody")
    r(admin, Action="BogusAction")
    r(admin, Action="DeleteAccessKey", AccessKeyId=admin[0])
    r(admin, Action="DeleteUser", UserName="root")
    r(admin, Action="PutUserPolicy", UserName="root", PolicyDocument=(
        '{"Statement": [{"Effect": "Allow", "Action": "s3:GetObject", "Resource": "*"}]}'))
    return out


def test_one_webdav_and_iam_script_gives_the_same_replies(tmp_path, monkeypatch):
    """The same WebDAV and IAM request scripts on a reference stack and a
    port stack: every status, the kept headers and every body (PROPFIND
    multistatus and IAM XML included) are equal, with the masks and seeds
    the section's comment names; the identities the IAM API persisted in
    the filer KV are equal too."""
    out = {}
    for name, p in PKGS.items():
        (tmp_path / name).mkdir()
        _seed_iam_ids(monkeypatch, p)
        with gateway_stack(p, tmp_path / name) as (dav, iam):
            out[name] = {"dav": _dav_script(dav), "iam": _iam_script(p, iam)}
            out[name]["kv"] = iam.filer.kv_get("s3_identities")
    assert len(out["port"]["dav"]) == len(out["ref"]["dav"])
    for ref, port in zip(out["ref"]["dav"], out["port"]["dav"]):
        assert port == ref
    for ref, port in zip(out["ref"]["iam"], out["port"]["iam"]):
        assert port == ref
    assert out["port"] == out["ref"]
    codes = {c for _, c, _ in out["port"]["iam"]}
    assert {200, 400, 403, 404, 409} <= codes, codes
    assert {c for _, _, c, _, _ in out["port"]["dav"]} >= {200, 201, 204, 207, 404, 405, 409,
                                                           412, 423}


@pytest.mark.parametrize("front", ["webdav", "iam"])
def test_the_gateways_set_tcp_nodelay_on_accepted_sockets(stack, monkeypatch, front):
    """The port's WebDAV and IAM fronts turn Nagle off on every accepted
    socket, as its S3 and filer fronts do; the reference's keep it on."""
    fs, dav, iam = stack
    mod, ref_mod = {"webdav": (port_davserver, ref_davserver),
                    "iam": (port_iamserver, ref_iamserver)}[front]
    seen = []
    setup = mod._Handler.setup

    def recording_setup(self):
        setup(self)
        seen.append(self.connection.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY))

    monkeypatch.setattr(mod._Handler, "setup", recording_setup)
    if front == "webdav":
        assert _req(f"http://{dav.url}", "OPTIONS", "/")[0] == 200
    else:
        assert _req(f"http://{iam.url}", "POST", "/", b"Action=ListUsers")[0] == 403
    assert seen and all(seen)
    assert not ref_mod._Handler.disable_nagle_algorithm
