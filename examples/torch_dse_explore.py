"""Design-space exploration walkthrough on the PyTorch port — the paper's
workflow as a tool.

Compile the SPD LBM core, sweep the (n, m) lattice on the FPGA model and
the (block_h, m) lattice on the H100 model, extract the Pareto frontiers,
execute the GPU frontiers through the generated Hopper stream kernels
(the uLBM PE and the 2-D diffusion app), and plan LM meshes with the same
spatial/temporal trade-off:

    PYTHONPATH=src python examples/torch_dse_explore.py --topk 1
    PYTHONPATH=src python examples/torch_dse_explore.py --device cpu --no-execute

The port of ``examples/dse_explore.py``. The implementation is
``python -m repro_torch.cli explore`` (:func:`repro_torch.cli.explore_main`,
docs/port.md §dse), which takes the same flags; ``--device`` defaults to
the card.
"""

from repro_torch.cli import explore_main


def main(argv=None):
    """Run the walkthrough; returns the report that ``--json`` writes."""
    return explore_main(argv)


if __name__ == "__main__":
    main()
