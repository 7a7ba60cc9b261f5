"""Metrics CLI of the port (reference ``computeMetrics.py:142-143``):

    python -m facet_graph_convolution_torch.cli.metrics \
        --base_path <dir> --results_path <dir>

Scores every ``<results_path>/<stem>_nK_denoised.obj`` against the ground
truth ``<base_path>/Data/Synthetic/test/original/<stem>.obj`` on the host
(:func:`..evaluation.driver.compute_metrics`): ``results_heat.csv``, the
heatmap OBJs and ``angDiffFinal.mat``.
"""

import argparse

from facet_graph_convolution_torch.config import add_cli_overrides, config_from_args
from facet_graph_convolution_torch.evaluation.driver import compute_metrics


def main(argv=None):
    parser = add_cli_overrides(argparse.ArgumentParser())
    cfg = config_from_args(parser.parse_args(argv))
    compute_metrics(cfg)


if __name__ == "__main__":
    main()
