"""Async OpenAI-compatible HTTP client for the generation seam (counterpart
of ``multimodal_colpali_tpu/generation/client.py``).

Generation stays a remote HTTP service, as in the reference (vLLM locally /
api.openai.com; reference functions.py:1017-1064, 02_experiment01.py:191-225):
asyncio fan-out over all prompts through a connection-capped session and
exponential-backoff retries returning the sentinel
``"[error] Retries FAILED [error]."`` after exhaustion.

The JAX package's client runs on ``aiohttp``; this one runs on the standard
library alone (``http.client`` calls on a session's own thread pool under the
event loop), since the GPU host's Python has no ``aiohttp``. It keeps
aiohttp's semantics where the reference depends on them:

- ``ClientSession(limit=N)`` holds at most ``N`` requests on the wire at once
  (``TCPConnector(limit=N)``); the others wait for a slot. The pool is the
  session's own: the loop's default executor would cap the fan-out at
  min(32, cpus + 4) in silence.
- A request has 300 s in all, waiting for a slot included, and 30 s to
  connect (aiohttp's default ``ClientTimeout(total=300, sock_connect=30)``).
- The body is ``json.dumps(data)``, as aiohttp's ``json=data`` writes it.
- :meth:`Response.json` raises :class:`ContentTypeError` for a mimetype that
  is not JSON, gives ``None`` for an empty body and lets
  ``json.JSONDecodeError`` through, as aiohttp's ``json()`` does.
- A refused connection, a dropped one or a malformed status line raises
  :class:`ClientError`, as aiohttp raises its ``ClientError`` subclasses; a
  timeout raises ``asyncio.TimeoutError``.

Deliberate difference: redirects are not followed (aiohttp follows them);
a 3xx reply is a status other than 200, so it is retried.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import http.client
import json
import os
import re
import time
import urllib.parse
from typing import Any, Dict, List, Optional, Sequence

ERROR_SENTINEL = "[error] Retries FAILED [error]."

TOTAL_TIMEOUT_S = 300.0
CONNECT_TIMEOUT_S = 30.0
# the mimetypes aiohttp's json() accepts: application/json and application/*+json
_JSON_MIMETYPE = re.compile(r"^application/(?:[\w.+-]+?\+)?json")


class ClientError(Exception):
    """A transport failure: refused or dropped connection, bad status line
    (aiohttp's ``ClientError``)."""


class ContentTypeError(ClientError):
    """:meth:`Response.json` on a reply whose mimetype is not JSON."""


class ResponseError(ClientError):
    """:meth:`Response.raise_for_status` on a status of 400 or more."""

    def __init__(self, status: int, url: str):
        super().__init__(f"{status} for {url}")
        self.status = status


class Response:
    """A read reply: status, headers and body."""

    def __init__(self, url: str, status: int, headers: Dict[str, str], body: bytes):
        self.url = url
        self.status = status
        self.headers = headers
        self.body = body

    @property
    def content_type(self) -> str:
        # aiohttp's default for a reply without the header
        return (self.headers.get("content-type") or "application/octet-stream").split(
            ";")[0].strip().lower()

    def _charset(self) -> str:
        for param in (self.headers.get("content-type") or "").split(";")[1:]:
            key, _, value = param.partition("=")
            if key.strip().lower() == "charset" and value.strip():
                return value.strip().strip('"')
        return "utf-8"

    def raise_for_status(self) -> None:
        if self.status >= 400:
            raise ResponseError(self.status, self.url)

    def json(self) -> Any:
        if not _JSON_MIMETYPE.match(self.content_type):
            raise ContentTypeError(
                f"attempt to decode JSON with unexpected mimetype: {self.content_type}")
        stripped = self.body.strip()
        if not stripped:
            return None
        return json.loads(stripped.decode(self._charset()))


def _post_blocking(url: str, headers: Dict[str, str], body: bytes, deadline: float) -> Response:
    """One POST on this thread, within ``deadline`` (``time.monotonic``).
    A timeout raises ``asyncio.TimeoutError``, which the retry loops catch
    (before Python 3.11 it is not the builtin ``TimeoutError``)."""
    remaining = deadline - time.monotonic()
    if remaining <= 0:      # the caller gave up while this waited for a slot
        raise asyncio.TimeoutError("no time left to send the request")
    parts = urllib.parse.urlsplit(url)
    conn_cls = (http.client.HTTPSConnection if parts.scheme == "https"
                else http.client.HTTPConnection)
    path = parts.path or "/"
    if parts.query:
        path += "?" + parts.query
    conn = conn_cls(parts.hostname, parts.port, timeout=min(CONNECT_TIMEOUT_S, remaining))
    try:
        conn.connect()
        conn.sock.settimeout(max(deadline - time.monotonic(), 1e-3))
        conn.request("POST", path, body=body, headers=headers)
        resp = conn.getresponse()
        data = resp.read()
        return Response(url, resp.status, {k.lower(): v for k, v in resp.getheaders()}, data)
    except TimeoutError as e:
        raise asyncio.TimeoutError(str(e)) from e
    except (OSError, http.client.HTTPException) as e:
        raise ClientError(f"{type(e).__name__}: {e}") from e
    finally:
        conn.close()


class ClientSession:
    """A connection-capped session (aiohttp's ``ClientSession`` over a
    ``TCPConnector(limit=limit)``): an async context manager whose
    :meth:`post` runs each request on the session's own pool of ``limit``
    threads, each within ``TOTAL_TIMEOUT_S``."""

    def __init__(self, limit: int):
        self.limit = limit
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None

    async def __aenter__(self) -> "ClientSession":
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.limit, thread_name_prefix="client")
        return self

    async def __aexit__(self, *exc) -> None:
        # a request that timed out may still hold its thread until its socket
        # times out; do not block the loop on it
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._pool = None

    async def post(self, url: str, headers: Dict[str, str], data: Any,
                   timeout: Optional[float] = None) -> Response:
        """POST ``data`` as a JSON body; -> the read :class:`Response`, within
        ``timeout`` seconds (aiohttp's ``post(..., timeout=)``; default
        ``TOTAL_TIMEOUT_S``)."""
        if self._pool is None:
            raise RuntimeError("ClientSession.post outside `async with`")
        timeout = TOTAL_TIMEOUT_S if timeout is None else timeout
        body = json.dumps(data).encode("utf-8")
        deadline = time.monotonic() + timeout
        loop = asyncio.get_running_loop()
        fut = loop.run_in_executor(self._pool, _post_blocking, url, headers, body, deadline)
        return await asyncio.wait_for(fut, timeout)


async def post_request_with_retries(
    session: ClientSession,
    url: str,
    headers: Dict[str, str],
    data: Dict[str, Any],
    retries: int = 5,
    backoff: float = 1.0,
) -> str:
    for attempt in range(retries):
        try:
            response = await session.post(url, headers=headers, data=data)
            if response.status == 200:
                response_data = response.json()
                choices = response_data.get("choices", [{}])
                content = choices[0].get("message", {}).get("content")
                # a 200 whose choices carry no message content would
                # leak None into -> List[str] pipelines (joins,
                # aggregators); degrade it like exhausted retries
                return content if isinstance(content, str) \
                    else ERROR_SENTINEL
            # non-200: retry
        except (ClientError, asyncio.TimeoutError):
            pass
        if attempt < retries - 1:
            await asyncio.sleep(backoff * (2 ** attempt))
    return ERROR_SENTINEL


async def post_request_with_retries_raising(
    session: ClientSession,
    url: str,
    headers: Dict[str, str],
    data: Dict[str, Any],
    retries: int = 5,
    backoff: float = 1.0,
) -> str:
    """Raising variant (reference 02_experiment01.py:191-203)."""
    last: Optional[Exception] = None
    for attempt in range(retries):
        try:
            response = await session.post(url, headers=headers, data=data)
            response.raise_for_status()
            response_data = response.json()
            return response_data["choices"][0]["message"]["content"]
        except (ClientError, asyncio.TimeoutError) as e:
            last = e
            if attempt < retries - 1:
                await asyncio.sleep(backoff * (2 ** attempt))
    raise RuntimeError(f"request failed after {retries} retries") from last


def resolve_endpoint(model: str, vllm_port: int = 8006,
                     base_url: Optional[str] = None) -> tuple:
    """(url, headers) for a model: OpenAI for gpt*, local vLLM otherwise.

    ``base_url`` (or $OPENAI_BASE_URL) overrides - this is also how tests
    point the client at an in-process server.
    """
    base = base_url or os.environ.get("OPENAI_BASE_URL")
    if base:
        url = base.rstrip("/") + "/chat/completions"
        key = os.environ.get("OPENAI_API_KEY", "EMPTY")
        return url, {"Authorization": f"Bearer {key}", "Content-Type": "application/json"}
    if model.startswith("gpt"):
        return (
            "https://api.openai.com/v1/chat/completions",
            {"Authorization": f"Bearer {os.environ.get('OPENAI_API_KEY', '')}",
             "Content-Type": "application/json"},
        )
    return (
        f"http://localhost:{vllm_port}/v1/chat/completions",
        {"Authorization": f"Bearer {os.environ.get('VLLM_API_KEY', 'EMPTY')}",
         "Content-Type": "application/json"},
    )


async def get_responses(
    model: str,
    vllm_port: int,
    processed_prompts: Sequence[List[Dict]],
    base_url: Optional[str] = None,
    connector_limit: int = 512,
    extra_body: Optional[Dict[str, Any]] = None,
) -> List[str]:
    """Fan out all prompts concurrently (reference functions.py:1036-1064)."""
    url, headers = resolve_endpoint(model, vllm_port, base_url)
    async with ClientSession(limit=connector_limit) as session:
        tasks = [
            post_request_with_retries(
                session, url=url, headers=headers,
                data={"model": model, "messages": msg, **(extra_body or {})},
            )
            for msg in processed_prompts
        ]
        return list(await asyncio.gather(*tasks))


async def get_response_context(
    query: str,
    context: Sequence[List[Dict]],
    model_name: str,
    url: str,
    headers: Dict[str, str],
    connector_limit: int = 512,
) -> str:
    """Two-phase ask: summarize every context prompt concurrently, then
    answer ``query`` over the joined summaries (reference
    functions.py:1684-1719).

    Behavioral deviation (intentional fix, as in the JAX package): the
    reference's second phase posts each message DICT of ``fin_query`` as the
    ``messages`` field - an invalid OpenAI payload. One final request with
    the full message list is sent instead, returning the answer string.
    """
    from multimodal_colpali_tpu_torch.generation.messages import format_msgs

    async with ClientSession(limit=connector_limit) as session:
        tasks = [
            post_request_with_retries(
                session, url=url, headers=headers,
                data={"model": model_name, "messages": msg},
            )
            for msg in context
        ]
        responses = await asyncio.gather(*tasks)

    # a summary that is not a string degrades to the sentinel instead of
    # failing the join (as the JAX package does)
    summaries = [r if isinstance(r, str) else ERROR_SENTINEL
                 for r in responses]
    fin_query = format_msgs(query + "Here is context information:", [],
                            "\n".join(summaries))
    async with ClientSession(limit=connector_limit) as session:
        return await post_request_with_retries(
            session, url=url, headers=headers,
            data={"model": model_name, "messages": fin_query},
        )


def mcq_response_format() -> Dict[str, Any]:
    """Structured-output schema forcing {"answer": "A|B|C|D"} - the pydantic
    ``MCQ`` schema of the reference (02_experiment01.py:50-55) as a raw
    json_schema response_format."""
    return {
        "type": "json_schema",
        "json_schema": {
            "name": "MCQ",
            "schema": {
                "type": "object",
                "properties": {"answer": {"type": "string", "enum": ["A", "B", "C", "D"]}},
                "required": ["answer"],
                "additionalProperties": False,
            },
            "strict": True,
        },
    }


async def run_inference(
    model: str,
    messages_list: Sequence[List[Dict]],
    url: Optional[str] = None,
    headers: Optional[Dict[str, str]] = None,
    use_schema: bool = False,
    connector_limit: int = 512,
) -> List[str]:
    """Reference 02_experiment01.py:206-225: gather with optional MCQ schema."""
    if url is None or headers is None:
        url, headers = resolve_endpoint(model)
    body: Dict[str, Any] = {}
    if use_schema:
        body["response_format"] = mcq_response_format()
    async with ClientSession(limit=connector_limit) as session:
        tasks = [
            post_request_with_retries(
                session, url, headers, {"model": model, "messages": m, **body}
            )
            for m in messages_list
        ]
        return list(await asyncio.gather(*tasks))


def run_sync(coro):
    """Run an async entry point from sync code, re-entrancy safe
    (replaces the reference's nest_asyncio shims, 02_experiment01.py:336-341):
    inside a running loop the coroutine runs on a worker thread."""
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return asyncio.run(coro)
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
        return ex.submit(asyncio.run, coro).result()
