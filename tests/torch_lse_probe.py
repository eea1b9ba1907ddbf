"""The float32 lse tolerance of ``tests/test_torch_flash_attention.py``
(ROADMAP Queue 3 #2): the worst |lse - JAX lse| that
``test_plain_forward_matches_fwd_kernels`` reads under each setting that
could change a float32 CPU result.  A one-off, not collected by pytest.

    JAX_PLATFORMS=cpu python -m tests.torch_lse_probe

runs that test file's forward cases 14 times: alone and under
``-n 6 --dist loadfile``, with torch at 1, 2 and all the machine's threads
(set per test, after ``torch_parity.py`` sets 2), with
``tests/conftest.py``'s 8-device ``XLA_FLAGS`` and with one device, and
twice through a JAX persistent compilation cache (written, then read
back), and prints one JSON line per run.  As a pytest plugin
(``-p tests.torch_lse_probe``) it records each lse comparison of any run,
a whole-suite run too, as a JSON line in ``$LSE_PROBE_OUT``, with torch at
``$LSE_PROBE_THREADS`` threads and the compilation cache in
``$LSE_PROBE_CACHE`` where those are set.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

FILE = "tests/test_torch_flash_attention.py"


def pytest_configure(config):
    from tests import torch_parity as tp

    real = tp.assert_close

    def recorded(got, want, rtol, atol, what=""):
        if what == "lse" and os.environ.get("LSE_PROBE_OUT"):
            g = got.detach().float().numpy() \
                if isinstance(got, torch.Tensor) else np.asarray(got)
            err = float(np.abs(g - np.asarray(want, np.float32)).max())
            with open(os.environ["LSE_PROBE_OUT"], "a") as f:
                f.write(json.dumps({"err": err,
                                    "threads": torch.get_num_threads()})
                        + "\n")
        return real(got, want, rtol, atol, what)

    tp.assert_close = recorded


def pytest_sessionstart(session):
    cache = os.environ.get("LSE_PROBE_CACHE")
    if cache:
        import jax

        jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


@pytest.fixture(autouse=True)
def _probe_threads():
    threads = os.environ.get("LSE_PROBE_THREADS")
    if threads:
        torch.set_num_threads(int(threads))
    yield


def _run(tmp: str, name: str, env: dict, xdist: bool) -> dict:
    out = os.path.join(tmp, f"{name}.jsonl")
    cmd = [sys.executable, "-m", "pytest", FILE, "-q", "-p",
           "no:cacheprovider", "-p", "tests.torch_lse_probe", "-k",
           "plain_forward"]
    if xdist:
        cmd += ["-p", "xdist", "-n", "6", "--dist", "loadfile"]
    proc = subprocess.run(cmd, env={**os.environ, **env,
                                    "LSE_PROBE_OUT": out},
                          capture_output=True, text=True, timeout=900)
    with open(out) as f:
        errs = [json.loads(line)["err"] for line in f]
    return {"run": name, "rc": proc.returncode, "cases": errs,
            "worst": max(errs)}


def main() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for xla in ("8 devices", "1 device"):
            # conftest.py adds the 8-device flag only where none is set
            env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=1"} \
                if xla == "1 device" else {}
            for threads in (1, 2, os.cpu_count()):
                for xdist in (False, True):
                    name = (f"{xla}, {threads} threads, "
                            f"{'-n 6' if xdist else 'alone'}")
                    runs.append(_run(tmp, name, dict(
                        env, LSE_PROBE_THREADS=str(threads)), xdist))
                    print(json.dumps(runs[-1]), flush=True)
        cache = os.path.join(tmp, "jax_cache")
        for name in ("cache written", "cache read"):
            runs.append(_run(tmp, name, {"LSE_PROBE_CACHE": cache}, False))
            print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"runs": len(runs),
                      "worst": max(r["worst"] for r in runs),
                      "failed": [r["run"] for r in runs if r["rc"]]}))


if __name__ == "__main__":
    main()
