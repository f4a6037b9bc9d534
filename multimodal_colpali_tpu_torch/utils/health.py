"""Generation-endpoint health checks and process monitoring (counterpart of
``multimodal_colpali_tpu/utils/health.py``).

Equivalents of the reference's vLLM operational checks
(``check_vllm_status``/``monitor_vllm_process``, functions.py:577-613), on
``urllib``: the GPU host's Python has no ``httpx``.
"""

from __future__ import annotations

import subprocess
import time
import urllib.error
import urllib.request
from typing import Tuple


def check_vllm_status(url: str = "http://localhost:8000/health") -> bool:
    """True if the serving endpoint answers its health route with 200.

    Any other status, and any connection error or timeout (5 s), is False,
    as ``httpx.get(...).status_code == 200`` with ``httpx.HTTPError`` caught
    gives in the JAX package."""
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status == 200
    except (urllib.error.URLError, OSError):    # HTTPError is a URLError
        return False


def monitor_vllm_process(vllm_process: subprocess.Popen, check_interval: int = 5,
                         health_url: str = "http://localhost:8000/health",
                         max_wait: float = 600.0) -> Tuple[bool, str, str]:
    """Wait for a serving subprocess to come up; stream its output meanwhile.

    Returns (success, stdout, stderr). Unlike the reference, a ``max_wait``
    bound prevents an infinite wait on a wedged server.
    """
    print("Starting server monitoring...")
    deadline = time.time() + max_wait
    while vllm_process.poll() is None and time.time() < deadline:
        if check_vllm_status(health_url):
            print("server is up and running")
            return True, "", ""
        print("Waiting for server to start...")
        time.sleep(check_interval)
        for stream, label in ((vllm_process.stdout, "STDOUT"),
                              (vllm_process.stderr, "STDERR")):
            if stream is not None and stream.readable():
                data = stream.read1().decode("utf-8", "replace") if hasattr(stream, "read1") else ""
                if data:
                    print(f"{label}:", data)
    if vllm_process.poll() is None:
        return False, "", f"server did not become healthy within {max_wait}s"
    stdout, stderr = vllm_process.communicate()
    return False, (stdout or b"").decode("utf-8", "replace"), (stderr or b"").decode("utf-8", "replace")
