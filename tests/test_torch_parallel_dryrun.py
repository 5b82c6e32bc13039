"""`python -m hybrid_diffusion_tpu_torch.parallel.dryrun --world 4`: four
gloo ranks on the CPU run a DP×TP train step on a 2×2 mesh, the ZeRO-1 step,
ring attention against dense attention and the batch-sharded sampler
against one process, and the parent prints one ok line (the counterpart of
tests/test_graft_entry.py's run of `dryrun_multichip`)."""

import re

from _torch_parity import one_torch_thread  # noqa: F401
from hybrid_diffusion_tpu_torch.parallel import dryrun


def test_dryrun_at_world_4_prints_its_ok_line(capsys):
    assert dryrun.main(["--world", "4"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(
        r"dryrun ok: world=4 mesh=2x2 loss=\d+\.\d+ zero1_loss=\d+\.\d+ "
        r"ring_attn=ok \(max err \S+\) sharded_sampler=ok \(max err \S+\) "
        r"wall=\S+s", line), line
