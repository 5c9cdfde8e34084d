"""The engine's StageTimer ``grid`` and ``eig_retry`` stages, in ms a
sweep: the factorisations and solves of every (lambda, held-out file)."""


def read(readings):
    if readings.get('kind') != 'sweep' or not readings['sweeps']:
        return None
    stages = readings['stages_s']
    return ((stages.get('grid', 0.0) + stages.get('eig_retry', 0.0)) /
            readings['sweeps'] * 1e3)
