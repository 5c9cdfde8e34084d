"""Mean/std errorbar plots for regression sweeps (copy of
utils/plot_util.py).

Parity with the reference plot_util.plot_mean_std (plot_util.py:32-98):
log-x errorbar plot with optional golden-results overlay. Matplotlib is
imported lazily so headless/compute-only installs don't need it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence


def plot_mean_std(test_name: str,
                  regularization_list: Sequence[float],
                  run_mean: Sequence[float],
                  run_std: Sequence[float],
                  golden_mean_std_dict: Optional[Dict] = None,
                  png_file_name: Optional[str] = None,
                  show_plot: bool = False):
    if len(regularization_list) != len(run_mean):
        raise ValueError('Regularization list and mean list lengths do not '
                         'match (%d vs %d).' % (len(regularization_list),
                                                len(run_mean)))
    if len(run_mean) != len(run_std):
        raise ValueError('Mean and std lists must have the same length.')
    import matplotlib
    matplotlib.use('Agg' if not show_plot else matplotlib.get_backend())
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.errorbar(regularization_list, run_mean, yerr=run_std,
                label='test results', capsize=3)
    if golden_mean_std_dict:
        golden_regs = sorted(golden_mean_std_dict.keys())
        golden_means = [golden_mean_std_dict[r][0] for r in golden_regs]
        golden_stds = [golden_mean_std_dict[r][1] for r in golden_regs]
        ax.errorbar(golden_regs, golden_means, yerr=golden_stds,
                    label='golden results', linestyle='--', capsize=3)
        ax.legend()
    ax.set_xscale('log')
    ax.set_xlabel('Regularization lambda')
    ax.set_ylabel('Correlation')
    ax.set_title(test_name)
    if png_file_name:
        fig.savefig(png_file_name, format='png')
    if show_plot:
        plt.show()
    plt.close(fig)
