"""Minimal blocking HTTP client on the standard library.

The cluster's coordinator client, peer probes and snapshot transfers need
a handful of request shapes; `urllib.request` covers them.  Non-2xx
answers come back as a Response (the caller maps statuses); transport
failures raise HttpError.  Environment proxies are ignored: cluster peers
talk to each other directly.
"""

from __future__ import annotations

import http.client
import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Mapping, Optional

_opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))


class HttpError(OSError):
    """The request never produced an HTTP response (connect, timeout, reset)."""


class Response:
    def __init__(self, status: int, body: bytes = b"", raw=None):
        self.status_code = status
        self.content = body
        self.raw = raw  # set for streamed responses; read1()/close() on it

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")

    def json(self):
        return json.loads(self.content)

    def close(self) -> None:
        if self.raw is not None:
            self.raw.close()


def request(
    method: str,
    url: str,
    *,
    data: Optional[bytes] = None,
    headers: Optional[Mapping[str, str]] = None,
    params: Optional[Mapping[str, object]] = None,
    timeout: Optional[float] = None,
    stream: bool = False,
) -> Response:
    """One request.  With `stream=True` the body is left unread on
    `Response.raw` (the caller must close it)."""
    if params:
        url += ("&" if "?" in url else "?") + urllib.parse.urlencode(params)
    req = urllib.request.Request(url, data=data, headers=dict(headers or {}), method=method)
    try:
        resp = _opener.open(req, timeout=timeout)
    except urllib.error.HTTPError as exc:
        resp = exc  # a non-2xx answer is still a response
    except (urllib.error.URLError, http.client.HTTPException, OSError) as exc:
        raise HttpError(str(exc)) from exc
    status = resp.status if resp.status is not None else resp.code
    if stream:
        return Response(status, raw=resp)
    try:
        body = resp.read()
    except (http.client.HTTPException, OSError) as exc:
        raise HttpError(str(exc)) from exc
    finally:
        resp.close()
    return Response(status, body)
