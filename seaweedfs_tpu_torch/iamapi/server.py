"""IAM query API server — weed/iamapi/iamapi_handlers.go analog. AWS IAM protocol subset: ListUsers,
GetUser, CreateUser, DeleteUser, CreateAccessKey, DeleteAccessKey,
PutUserPolicy (policy statements mapped onto the gateway's action list,
as the reference's iamapi does).
"""

from __future__ import annotations

import json
import secrets
import threading
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from typing import Optional

from seaweedfs_tpu_torch.filer.client import FilerClient
from seaweedfs_tpu_torch.s3api.auth import (
    ACTION_ADMIN,
    Iam,
    Identity,
    load_identities,
    save_identities,
)
from seaweedfs_tpu_torch.utils import httpd
from seaweedfs_tpu_torch.security import tls

_MUTATING = {
    "CreateUser",
    "DeleteUser",
    "CreateAccessKey",
    "DeleteAccessKey",
    "PutUserPolicy",
}


# policy Action string -> gateway action (auth_credentials.go mapping)
_POLICY_ACTIONS = {
    "s3:*": "Admin",
    "s3:GetObject": "Read",
    "s3:PutObject": "Write",
    "s3:ListBucket": "List",
    "s3:ListAllMyBuckets": "List",
    "s3:DeleteObject": "Write",
}


class IamApiServer:
    def __init__(
        self,
        filer_grpc_address: str,
        iam: Optional[Iam] = None,
        port: int = 0,
        host: str = "127.0.0.1",
        bootstrap_token: Optional[str] = None,
        extra_hosts: Optional[set[str]] = None,
    ):
        self.filer = FilerClient(filer_grpc_address)
        self.iam = iam if iam is not None else (load_identities(self.filer) or Iam())
        self.host = host
        # pre-lowercased: the auth host compare is a plain set lookup
        self.extra_hosts = {h.lower() for h in (extra_hosts or ())}
        # pre-shared secret gating the fresh-cluster bootstrap: with no
        # credentialed identity yet, only a caller presenting this token
        # may mint the first admin. Without a token configured the API is
        # CLOSED until identities arrive via config/S3 seeding — never
        # first-come-first-served (the reference has no open window at
        # all; its identities come from config).
        self.bootstrap_token = bootstrap_token
        self.lock = threading.Lock()  # identities list is shared state
        self._http = _ThreadingHTTPServer((host, port), _Handler)
        tls.maybe_wrap_https(self._http)  # data-path HTTPS when configured
        self._http.iam_server = self
        self.port = self._http.server_address[1]
        self.extra_hosts |= {f"{h}:{self.port}" for h in httpd.loopback_aliases(host)}
        self._thread = threading.Thread(target=self._http.serve_forever, daemon=True)

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._http.shutdown()
        self._http.server_close()
        self.filer.close()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def persist(self) -> None:
        save_identities(self.filer, self.iam)


class _ThreadingHTTPServer(httpd.ThreadingHTTPServer):
    iam_server: "IamApiServer"


def _resp(action: str, inner: Optional[ET.Element] = None) -> bytes:
    root = ET.Element(f"{action}Response")
    root.set("xmlns", "https://iam.amazonaws.com/doc/2010-05-08/")
    if inner is not None:
        result = ET.SubElement(root, f"{action}Result")
        result.append(inner)
    meta = ET.SubElement(root, "ResponseMetadata")
    rid = ET.SubElement(meta, "RequestId")
    rid.text = uuid.uuid4().hex
    return b'<?xml version="1.0" encoding="UTF-8"?>\n' + ET.tostring(root)


def _error(code: int, iam_code: str, msg: str = "") -> tuple[int, bytes]:
    root = ET.Element("ErrorResponse")
    err = ET.SubElement(root, "Error")
    ET.SubElement(err, "Code").text = iam_code
    ET.SubElement(err, "Message").text = msg or iam_code
    return code, b'<?xml version="1.0" encoding="UTF-8"?>\n' + ET.tostring(root)


class _Handler(httpd.QuietHandler):
    # headers and body leave in two writes: with Nagle on, the body waits
    # for the client's delayed ACK (~40 ms per small reply on a keep-alive
    # connection), as on the filer's and the volume server's fronts
    disable_nagle_algorithm = True

    @property
    def srv(self) -> IamApiServer:
        return self.server.iam_server

    def do_POST(self):
        raw = self.read_body()
        if raw is None:
            self.reply_length_required()
            return
        # every IAM action requires SigV4 auth by an Admin identity —
        # an unauthenticated caller could otherwise mint Admin
        # credentials (PutUserPolicy s3:*) that the S3 gateway honors.
        # The gate keys on "a credentialed ADMIN exists", not "any
        # credential exists": bootstrapping in the AWS-natural order
        # (CreateUser → CreateAccessKey → PutUserPolicy) mints a key
        # with empty actions first, and gating on any-credential would
        # close the token path at that moment with no admin to sign as —
        # locking the API permanently. Fresh cluster: before deciding,
        # re-read the filer KV — an S3 gateway may have seeded
        # identities there after this server started.
        def _has_admin() -> bool:
            return any(
                i.access_key and i.can_do(ACTION_ADMIN)
                for i in self.srv.iam.identities
            )

        if not _has_admin():
            with self.srv.lock:
                fresh = load_identities(self.srv.filer)
                if fresh is not None and any(i.access_key for i in fresh.identities):
                    keys = {i.access_key for i in fresh.identities if i.access_key}
                    names = {i.name for i in fresh.identities}
                    self.srv.iam.identities = fresh.identities + [
                        i
                        for i in self.srv.iam.identities
                        if i.access_key not in keys
                        and (i.access_key or i.name not in names)
                    ]
        if _has_admin():
            u = urllib.parse.urlparse(self.path)
            headers = {k.lower(): v for k, v in self.headers.items()}
            identity, err = self.srv.iam.authenticate(
                "POST", urllib.parse.unquote(u.path) or "/", u.query, headers, raw,
                expect_service="iam",
                expect_hosts={self.srv.url.lower()} | self.srv.extra_hosts,
            )
            if identity is None:
                code, body = _error(403, err or "AccessDenied")
                self.send_reply(code, body, "text/xml")
                return
            if not identity.can_do(ACTION_ADMIN):
                code, body = _error(403, "AccessDenied", "Admin privileges required")
                self.send_reply(code, body, "text/xml")
                return
        else:
            # bootstrap: nothing to sign with yet. Gate admin minting on
            # the pre-shared token; with no token configured the API is
            # closed — first-to-reach-the-port must never become Admin.
            import hmac as _hmac

            presented = self.headers.get("x-seaweedfs-bootstrap-token", "")
            if not self.srv.bootstrap_token or not _hmac.compare_digest(
                presented, self.srv.bootstrap_token
            ):
                code, body = _error(
                    403,
                    "AccessDenied",
                    "no credentialed identities yet; bootstrap requires the "
                    "pre-shared token (-iam.bootstrapToken) or config/S3-seeded "
                    "identities",
                )
                self.send_reply(code, body, "text/xml")
                return
        form = {
            k: v[0] for k, v in urllib.parse.parse_qs(raw.decode()).items()
        }
        action = form.get("Action", "")
        handler = getattr(self, f"_do_{action}", None)
        if handler is None:
            code, body = _error(400, "InvalidAction", action)
        else:
            with self.srv.lock:
                code, body = handler(form)
                if code == 200 and action in _MUTATING:
                    self.srv.persist()
        self.send_reply(code, body, "text/xml")

    # -- actions --------------------------------------------------------------

    def _find_by_name(self, name: str) -> list[Identity]:
        return [i for i in self.srv.iam.identities if i.name == name]

    def _do_ListUsers(self, form):
        users = ET.Element("Users")
        seen = set()
        for i in self.srv.iam.identities:
            if i.name in seen:
                continue
            seen.add(i.name)
            m = ET.SubElement(users, "member")
            ET.SubElement(m, "UserName").text = i.name
        return 200, _resp("ListUsers", users)

    def _do_GetUser(self, form):
        name = form.get("UserName", "")
        if not self._find_by_name(name):
            return _error(404, "NoSuchEntity", name)
        user = ET.Element("User")
        ET.SubElement(user, "UserName").text = name
        return 200, _resp("GetUser", user)

    def _do_CreateUser(self, form):
        name = form.get("UserName", "")
        if not name:
            return _error(400, "InvalidInput")
        if self._find_by_name(name):
            return _error(409, "EntityAlreadyExists", name)
        self.srv.iam.identities.append(Identity(name, "", "", []))
        user = ET.Element("User")
        ET.SubElement(user, "UserName").text = name
        return 200, _resp("CreateUser", user)

    def _would_drop_last_admin(self, doomed) -> bool:
        """True when removing/revoking `doomed` identities leaves no
        credentialed Admin — which would silently re-open the bootstrap
        gate on a live cluster."""
        doomed_ids = {id(i) for i in doomed}
        return not any(
            i.access_key and i.can_do(ACTION_ADMIN)
            for i in self.srv.iam.identities
            if id(i) not in doomed_ids
        )

    def _do_DeleteUser(self, form):
        name = form.get("UserName", "")
        matches = self._find_by_name(name)
        if not matches:
            return _error(404, "NoSuchEntity", name)
        if self._would_drop_last_admin(matches):
            return _error(
                409, "DeleteConflict", "refusing to delete the last credentialed admin"
            )
        self.srv.iam.identities = [
            i for i in self.srv.iam.identities if i.name != name
        ]
        return 200, _resp("DeleteUser")

    def _do_CreateAccessKey(self, form):
        name = form.get("UserName", "")
        matches = self._find_by_name(name)
        access_key = "AKID" + secrets.token_hex(8)
        secret_key = secrets.token_urlsafe(24)
        if matches and not matches[0].access_key:
            # fill the empty credential slot created by CreateUser
            matches[0].access_key = access_key
            matches[0].secret_key = secret_key
        else:
            actions = matches[0].actions if matches else []
            self.srv.iam.identities.append(
                Identity(name or access_key, access_key, secret_key, list(actions))
            )
        ak = ET.Element("AccessKey")
        ET.SubElement(ak, "UserName").text = name
        ET.SubElement(ak, "AccessKeyId").text = access_key
        ET.SubElement(ak, "SecretAccessKey").text = secret_key
        ET.SubElement(ak, "Status").text = "Active"
        return 200, _resp("CreateAccessKey", ak)

    def _do_DeleteAccessKey(self, form):
        key = form.get("AccessKeyId", "")
        doomed = [i for i in self.srv.iam.identities if i.access_key == key]
        if doomed and self._would_drop_last_admin(doomed):
            return _error(
                409, "DeleteConflict", "refusing to revoke the last credentialed admin key"
            )
        # revoke the credential but keep the user (AWS semantics)
        for i in doomed:
            i.access_key = ""
            i.secret_key = ""
        return 200, _resp("DeleteAccessKey")

    def _do_PutUserPolicy(self, form):
        name = form.get("UserName", "")
        matches = self._find_by_name(name)
        if not matches:
            return _error(404, "NoSuchEntity", name)
        try:
            doc = json.loads(form.get("PolicyDocument", "{}"))
        except ValueError:
            return _error(400, "MalformedPolicyDocument")
        actions: list[str] = []
        if not isinstance(doc, dict) or not isinstance(doc.get("Statement", []), list):
            return _error(400, "MalformedPolicyDocument")
        for st in doc.get("Statement", []):
            if not isinstance(st, dict):
                return _error(400, "MalformedPolicyDocument")
            if st.get("Effect") != "Allow":
                continue
            acts = st.get("Action", [])
            if isinstance(acts, str):
                acts = [acts]
            resources = st.get("Resource", [])
            if isinstance(resources, str):
                resources = [resources]
            buckets = set()
            for r in resources:
                # arn:aws:s3:::bucket/key or *
                tail = r.rsplit(":::", 1)[-1]
                bucket = tail.split("/", 1)[0]
                if bucket and bucket != "*":
                    buckets.add(bucket)
            for a in acts:
                mapped = _POLICY_ACTIONS.get(a)
                if mapped is None:
                    continue
                if buckets:
                    actions.extend(f"{mapped}:{b}" for b in sorted(buckets))
                else:
                    actions.append(mapped)
        new_actions = sorted(set(actions))
        if ACTION_ADMIN not in new_actions and any(
            i.access_key and i.can_do(ACTION_ADMIN) for i in matches
        ):
            # demoting the sole credentialed admin would lock the IAM API
            # with no recovery path (the key still exists, so the
            # bootstrap gate stays closed) — same lockout DeleteUser guards
            if self._would_drop_last_admin(matches):
                return _error(
                    409, "DeleteConflict", "refusing to demote the last credentialed admin"
                )
        for i in matches:
            i.actions = new_actions
        return 200, _resp("PutUserPolicy")
