"""Mirror of test_0124_tsan on the port: the port's own copy of the
native codec (librdkafka_tpu_torch/ops/native/codec.cpp) built with the
reference's unchanged driver, tests/tsan_codec.cpp, under
-fsanitize=thread.  The driver calls the *_many entry points from many
threads at once, as broker and codec-worker threads of several clients
do; any ThreadSanitizer report fails the test (halt_on_error with exit
code 66).  It skips as 0124 does: without g++, or with a toolchain that
lacks ThreadSanitizer.
"""
import os
import shutil
import subprocess

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
CODEC = os.path.join(HERE, "..", "librdkafka_tpu_torch", "ops", "native",
                     "codec.cpp")


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_port_native_codec_under_tsan(tmp_path):
    exe = str(tmp_path / "tsan_codec")
    probe = tmp_path / "probe.cpp"
    probe.write_text("int main(){return 0;}\n")
    try:
        subprocess.run(["g++", "-fsanitize=thread", str(probe),
                        "-o", str(tmp_path / "probe")],
                       check=True, capture_output=True)
    except subprocess.CalledProcessError:
        pytest.skip("toolchain lacks ThreadSanitizer")
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-g", "-fsanitize=thread",
         "-pthread", CODEC, os.path.join(HERE, "tsan_codec.cpp"),
         "-o", exe],
        check=True, capture_output=True)
    env = dict(os.environ)
    env["TSAN_OPTIONS"] = "halt_on_error=1 exitcode=66"
    r = subprocess.run([exe], capture_output=True, text=True, timeout=300,
                       env=env)
    assert r.returncode == 0, (
        f"rc={r.returncode} (66 = TSAN report)\n{r.stderr[-4000:]}")
    assert "TSAN-CODEC-OK" in r.stdout
