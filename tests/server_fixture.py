"""Subprocess server fixture for e2e tests: spawns the real process, waits
for readiness, supports soft (SIGTERM) and hard (SIGKILL) restarts against a
persistent data dir."""

import os
import signal
import subprocess
import sys
import time

import requests

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def post_search(url, retry_s=60.0, **kwargs):
    """POST a search, retrying 503 SearchTimeout/IndexNotReady responses.

    The search deadline is absolute (matching the reference's AutoCancel,
    MultiIndex.zig:314-316): a request that lands behind a cold program
    compile is refused with 503 SearchTimeout rather than served late, and
    503 is the retryable status by contract — the same way the cluster
    tests poll through 503-while-bootstrapping."""
    deadline = time.time() + retry_s
    while True:
        r = requests.post(url, **kwargs)
        if r.status_code == 503 and time.time() < deadline:
            err = None
            try:
                err = r.json().get("error")
            except Exception:
                try:
                    import msgpack

                    d = msgpack.unpackb(r.content)
                    err = d.get("e") or d.get("error")
                except Exception:
                    pass
            if err in ("SearchTimeout", "IndexNotReady"):
                time.sleep(0.1)
                continue
        return r


class Server:
    def __init__(self, data_dir, extra_args=(), env_extra=None):
        self.data_dir = str(data_dir)
        self.extra_args = list(extra_args)
        self.proc = None
        self.port = None
        self.search_port = None  # native search plane (--search-port)
        self.env_extra = env_extra or {}

    def start(self):
        os.makedirs(self.data_dir, exist_ok=True)
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env["AITPU_JAX_PLATFORMS"] = "cpu"
        env.update(self.env_extra)
        self.proc = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "acoustid_index.main",
                "--dir",
                self.data_dir,
                "--port",
                "0",
                *self.extra_args,
            ],
            stdout=subprocess.PIPE,
            stderr=open(os.path.join(self.data_dir, "server_stderr.log"), "ab"),
            text=True,
            env=env,
            cwd=REPO,
        )
        deadline = time.time() + 120
        want_search_plane = "--search-port" in self.extra_args
        self.search_port = None
        while time.time() < deadline:
            # Blocking readline is safe: every startup path either prints
            # its announce line or exits (readline returns '' on EOF).
            # NOTE: do not mix select() with this buffered reader — both
            # announce lines can arrive in one read, leaving the second in
            # the user-space buffer where select can't see it.
            line = self.proc.stdout.readline()
            if line.startswith("LISTENING"):
                self.port = int(line.split()[1])
                if not want_search_plane:
                    break
            elif line.startswith("SEARCHPLANE"):
                self.search_port = int(line.split()[1])
                break
            if self.proc.poll() is not None:
                raise RuntimeError("server died on startup")
        else:
            raise RuntimeError("server did not start in time")
        self.wait_healthy()
        return self

    def wait_healthy(self, timeout=30):
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                if requests.get(self.url("/_health"), timeout=2).status_code == 200:
                    return
            except (requests.ConnectionError, requests.Timeout):
                pass  # startup warmup tracing can starve early responses
            time.sleep(0.05)
        raise RuntimeError("server not healthy")

    def url(self, path):
        return f"http://127.0.0.1:{self.port}{path}"

    def stop(self, hard=False):
        if self.proc is None:
            return
        self.proc.send_signal(signal.SIGKILL if hard else signal.SIGTERM)
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.proc = None

    def restart(self, hard=False):
        self.stop(hard=hard)
        self.start()
