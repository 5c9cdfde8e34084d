"""The engine's StageTimer ``moments`` stage (synchronised at its end),
in ms a sweep: K2's lag stacks and the per-file moments."""


def read(readings):
    if readings.get('kind') != 'sweep' or not readings['sweeps']:
        return None
    return readings['stages_s'].get('moments', 0.0) / readings['sweeps'] * 1e3
