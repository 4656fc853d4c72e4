"""rednose_tpu_torch/_build.py's write step of an emitted variant, without
nvcc: two processes that build the same variant at once (two ranks, two
test workers) write the same emitted source and template into the same
directory; each writes to a name of its own and renames it into place,
so a reader (nvcc, in either process) never sees a half-written file."""

import multiprocessing
import pathlib

from rednose_tpu_torch import _build


def _writer(d, source, times):
  for _ in range(times):
    _build.write_generated(pathlib.Path(d), source)


def test_two_processes_write_one_variant(tmp_path):
  source = "// an emitted variant\n" + "x = y;\n" * (1 << 19)   # 3.5 MB
  d = tmp_path / "gen_0123456789abcdef"
  ctx = multiprocessing.get_context("spawn")
  procs = [ctx.Process(target=_writer, args=(str(d), source, 20))
           for _ in range(2)]
  for p in procs:
    p.start()
  reads = 0
  while any(p.is_alive() for p in procs):
    try:
      text = (d / "gen.cu").read_text()
    except FileNotFoundError:
      continue
    assert text == source, f"read {len(text)} of {len(source)} characters"
    reads += 1
  for p in procs:
    p.join(timeout=60)
    assert p.exitcode == 0
  assert reads > 0
  assert (d / "gen.cu").read_text() == source
  assert (d / _build.TEMPLATE.name).read_bytes() == \
      _build.TEMPLATE.read_bytes()
  assert sorted(f.name for f in d.iterdir()) == sorted(
      ["gen.cu", _build.TEMPLATE.name])
