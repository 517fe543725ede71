"""Seconds of test time per test file, from a pytest JUnit XML report.

    python -m swindet_tpu_torch.tools.junit_times report.xml [other.xml]

Sums each file's test cases (setup, call and teardown together, as pytest
reports them) and prints the files in descending order, with the report's
total and its count of passes. With two reports it prints both columns,
the second's file order, and the change. Under pytest-xdist's
``--dist loadfile`` a file runs on one worker, so its sum is the wall time
it held that worker.
"""
from __future__ import annotations

import argparse
import collections
import xml.etree.ElementTree as ET
from typing import Dict, Tuple


def file_seconds(path: str) -> Tuple[Dict[str, float], int]:
    """Per-file summed seconds of a JUnit report, and its passes."""
    seconds: Dict[str, float] = collections.defaultdict(float)
    passed = 0
    for case in ET.parse(path).getroot().iter('testcase'):
        # 'tests.test_torch_atss' or 'tests.test_core.test_nms.TestNMS':
        # the module is the path without its test classes
        name = case.get('classname', '').split('.')
        while len(name) > 1 and name[-1][:1].isupper():
            name.pop()
        seconds['/'.join(name) + '.py'] += float(case.get('time', 0.0))
        if not any(c.tag in ('failure', 'error', 'skipped') for c in case):
            passed += 1
    return dict(seconds), passed


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('reports', nargs='+')
    args = ap.parse_args(argv)
    runs = [file_seconds(p) for p in args.reports[:2]]
    last = runs[-1][0]
    names = sorted(set().union(*[r[0] for r in runs]),
                   key=lambda k: -last.get(k, 0.0))
    for name in names:
        secs = [r[0].get(name, 0.0) for r in runs]
        cols = [f'{t:9.1f}' for t in secs]
        if len(runs) == 2:
            cols.append(f'{secs[1] - secs[0]:+9.1f}')
        print(' '.join(cols), name)
    print(' '.join(f'{sum(r[0].values()):9.1f}' for r in runs), 'total;',
          ' / '.join(str(r[1]) for r in runs), 'passed')


if __name__ == '__main__':
    main()
