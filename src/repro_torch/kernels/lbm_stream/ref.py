"""Full-grid torch oracle for the fused m-step LBM kernel."""

from __future__ import annotations

from repro_torch.apps.lbm import ref_step


def lbm_multistep_ref(f, attr, one_tau, u_lid, m: int):
    """m periodic LBM steps: the semantics the kernel must reproduce."""
    for _ in range(m):
        f = ref_step(f, attr, one_tau, u_lid, mode="wrap")
    return f
