"""CSV result files for regression sweeps (copy of utils/csv_util.py).

Parity with the reference csv_util.py (write_results :34-55,
_read_results/read_all_results_from_directory :58-111,
plot_csv_results :114-146). Row format: regularization value followed by
one correlation per test file.
"""

from __future__ import annotations

import collections
import csv
import os
from typing import Dict, List, Optional

import numpy as np


def write_results(file_name: str, regularization_list, all_results):
    if len(regularization_list) != len(all_results):
        raise ValueError('Length of regularization list and results do no '
                         'match.')
    base_dir = os.path.split(file_name)[0]
    if base_dir:
        os.makedirs(base_dir, exist_ok=True)
    with open(file_name, 'w', newline='') as csv_file:
        writer = csv.writer(csv_file)
        for regularization, row_values in zip(regularization_list,
                                              all_results):
            writer.writerow([str(regularization)] +
                            [str(v) for v in row_values])


def _read_results(file_name: str, skip_header: bool = False
                  ) -> 'collections.OrderedDict[float, List[float]]':
    results = collections.OrderedDict()
    with open(file_name, 'r') as csv_file:
        content = list(csv.reader(csv_file))
    if skip_header:
        del content[0]
    for row in content:
        if len(row) < 2:
            raise ValueError('Row %s does not have enough columns.' % row)
        results[float(row[0])] = [float(c) for c in row[1:]]
    return results


def read_all_results_from_directory(dir_name: str,
                                    skip_header: bool = False,
                                    pattern: str = ''
                                    ) -> 'collections.OrderedDict':
    all_results = collections.OrderedDict()
    for name in sorted(os.listdir(dir_name)):
        if not name.endswith('csv') or pattern not in name:
            continue
        curr = _read_results(os.path.join(dir_name, name), skip_header)
        if not all_results:
            all_results = curr
            continue
        if all_results.keys() != curr.keys():
            raise ValueError('Files do not have the same regularization '
                             'values %s vs %s' % (all_results.keys(),
                                                  curr.keys()))
        for reg, correlations in curr.items():
            all_results[reg].extend(correlations)
    return all_results


def plot_csv_results(test_name: str, results,
                     golden_mean_std_dict: Optional[Dict] = None,
                     png_file_name: Optional[str] = None,
                     show_plot: bool = False):
    from telluride_decoding_torch.utils import plot_util
    regularization_list, mean_list, std_list = [], [], []
    for reg, correlations in results.items():
        regularization_list.append(reg)
        mean_list.append(np.mean(correlations))
        std_list.append(np.std(correlations))
    plot_util.plot_mean_std(test_name, regularization_list, mean_list,
                            std_list,
                            golden_mean_std_dict=golden_mean_std_dict,
                            png_file_name=png_file_name,
                            show_plot=show_plot)
