"""PyTorch and CUDA port of telluride_decoding_tpu.

The JAX package ``telluride_decoding_tpu`` is the reference; each file
here pairs with the file of the same path there. This package imports
neither JAX nor the JAX package. Its kernels are hand-written CUDA for
Hopper under ``csrc/``; beside each sits a plain PyTorch version, which
runs for tensors on the CPU.

Subpackages (the JAX package's, name for name)
-----------
ops      : numeric primitives and the kernels' wrappers (pearson,
           covariance, lag stacking, the fused front end, the decode)
solvers  : deterministic linear-algebra solvers (ridge, CCA, LDA)
models   : brain models (linear, CCA, DNN, classifier, DCCA)
data     : dataset assembly, TFRecord I/O, file filtering
decode   : correlation decoding, reductions and d'
decide   : attention decision (WTA, stepped, state-space)
signal   : preprocessing (IIR filters, resampling, audio features)
sweep    : parameter searches from per-file moments (lambda grids,
           jackknife), sharded over a process group
io       : raw-format ingest (EDF, BrainVision, WAV, MATLAB)
parallel : meshes over a torch.distributed process group
cli      : command-line drivers with the reference's flags
utils    : results, CSV, plot and timing helpers
"""

__version__ = "0.1.0"

_SUBPACKAGES = ('ops', 'solvers', 'models', 'data', 'decode', 'decide',
                'signal', 'io', 'sweep', 'parallel', 'cli', 'utils')


def __getattr__(name):
    """Lazy subpackage imports: ``tdt.models`` works without importing
    every subpackage (and torch) when the package is imported."""
    if name in _SUBPACKAGES:
        import importlib
        module = importlib.import_module('telluride_decoding_torch.' + name)
        globals()[name] = module
        return module
    raise AttributeError('module %r has no attribute %r' %
                         (__name__, name))
