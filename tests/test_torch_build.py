"""The port's native build helper: jobs that name the same library share
one compiler run."""
import os
import sys

from m6anet_tpu_torch.ops import _build

# a stand-in compiler: `<command> SOURCE -o OUT` copies SOURCE to OUT and
# logs one line per run
_COMPILER = (
    "import shutil, sys; shutil.copy(sys.argv[1], sys.argv[3]); "
    "open(sys.argv[1] + '.runs', 'a').write('run\\n')"
)


def test_jobs_with_the_same_bytes_share_one_build(tmp_path):
    a, b, c = tmp_path / "a", tmp_path / "b", tmp_path / "c"
    for d in (a, b, c):
        d.mkdir()
    (a / "kernel.cu").write_text("one")
    (b / "kernel.cu").write_text("one")  # same stem and bytes: same library
    (c / "kernel.cu").write_text("two")
    command = [sys.executable, "-c", _COMPILER]
    out = tmp_path / "out"
    jobs = [(str(d / "kernel.cu"), command) for d in (a, b, c)]
    libs = _build.build_shared_libraries(jobs, out_dir=str(out))
    assert libs[0] == libs[1] != libs[2]
    assert all(os.path.exists(p) and os.path.exists(p + ".log") for p in libs)

    def runs():
        logs = [d / "kernel.cu.runs" for d in (a, b, c)]
        return sum(len(f.read_text().split()) for f in logs if f.exists())

    assert runs() == 2
    assert sorted(os.listdir(out)) == sorted({os.path.basename(p) for p in libs}
                                             | {os.path.basename(p) + ".log" for p in libs})
    # a second call reuses both libraries and runs no compiler
    assert _build.build_shared_libraries(jobs, out_dir=str(out)) == libs
    assert runs() == 2
