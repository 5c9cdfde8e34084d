"""AOT serving artifacts of the PyTorch port (decode/aot.py,
cli/export_aot.py, their serving by cli/serve.py) against the JAX
package's (tests/test_aot.py).

Each case of tests/test_aot.py runs here against both packages
(``[jax]`` and ``[torch]``) on the same JAX-written model directory and
the same numpy inputs; the JAX artifacts are exported for the CPU only,
to keep the fixtures fast. Then the two packages' artifacts of one model
directory score alike: a linear model (reduction first), a CCA and a
deep CCA (lda, where the port's program holds kernel K1 as one op) and a
DNN (lda, plain torch), at 1, 64 and 100 frames, within SCORE_TOL (the
fused decode's float32 bound, as in test_torch_serve.py); the port's
artifact gives its live decoder's scores within LIVE_TOL, the JAX
suite's own bound between an artifact and its live decoder.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from telluride_decoding_tpu.cli import export_aot as jax_export_aot
from telluride_decoding_tpu.cli import serve as jax_serve
from telluride_decoding_tpu.cli.infer import load_model as jax_load_model
from telluride_decoding_tpu.decode import aot as jax_aot
from telluride_decoding_tpu.decode import infer_decoder as jax_infer
from telluride_decoding_tpu.models import BrainModelDCCA as JaxDCCA
from telluride_decoding_tpu.models import BrainModelDNN as JaxDNN
from telluride_decoding_torch.cli import export_aot
from telluride_decoding_torch.cli import serve
from telluride_decoding_torch.cli.infer import load_model
from telluride_decoding_torch.decode import aot, infer_decoder
from telluride_decoding_torch.ops import decode_kernel

from test_serve import _toy_model_dir
from test_torch_infer_decoder import (CHANNELS, FLAGS, jax_model_dir,
                                      recordings, stacked)

SCORE_TOL = 1e-4
LIVE_TOL = 1e-6
FRAMES = (1, 64, 100)
WIDTHS = {'linear': (6, 1), 'cca': (CHANNELS * 5, 5),
          'dcca': (CHANNELS * 5, 5), 'dnn': (CHANNELS * 5, 5)}
REDUCTIONS = {'linear': 'first', 'cca': 'lda', 'dcca': 'lda', 'dnn': 'lda'}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K1_OP = torch.ops.tdt.fused_cca_decode_f32.default


class Package:
    """One package's AOT calls, the port's on the CPU."""

    def __init__(self, name):
        self.name = name
        port = name == 'torch'
        self.aot = aot if port else jax_aot
        self.serve = serve if port else jax_serve
        self.export_aot = export_aot if port else jax_export_aot
        self._device = ('cpu',) if port else ()
        self.cli_device = ['--device', 'cpu'] if port else []
        self.platforms = None if port else ('cpu',)

    def load_model(self, model_dir, reduction):
        return (load_model(model_dir, reduction, 'cpu') if self.name ==
                'torch' else jax_load_model(model_dir, reduction))

    def load_exported(self, artifact):
        return self.aot.load_exported_decoder(artifact, *self._device)

    def load_serving(self, path, reduction):
        return self.serve._load_serving_decoder(path, reduction,
                                                *self._device)

    def serve_stream(self, path, eeg, a1, a2, **kwargs):
        if self.name == 'torch':
            kwargs['device'] = 'cpu'
        return self.serve.serve_stream(path, eeg, a1, a2, **kwargs)

    def export(self, decoder, artifact, **kwargs):
        kwargs.setdefault('platforms', self.platforms)
        return self.aot.export_decoder(decoder, artifact, **kwargs)

    @property
    def live_class(self):
        return (infer_decoder if self.name == 'torch' else
                jax_infer).Decoder


PACKAGES = ('jax', 'torch')


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return Package(request.param)


@pytest.fixture(scope='module')
def toy(tmp_path_factory):
    """The JAX suite's toy model dir and, per package, its decoder and
    artifact (the port's exported for its default platforms)."""
    rng = np.random.RandomState(20260818)
    tmp = tmp_path_factory.mktemp('aot')
    model_dir, eeg, a1 = _toy_model_dir(tmp, rng, pre=2, post=3)
    out = {'model_dir': model_dir, 'eeg': eeg, 'a1': a1}
    for name in PACKAGES:
        package = Package(name)
        decoder = package.load_model(model_dir, 'first')
        artifact = str(tmp / ('artifact_' + name))
        out[name] = {'decoder': decoder, 'artifact': artifact,
                     'manifest': package.export(decoder, artifact,
                                                input_widths=(6, 1),
                                                output_width=1)}
    return out


# -- TestExport of tests/test_aot.py ------------------------------------------

def test_manifest_contents(toy, pkg):
    mine = toy[pkg.name]
    m = json.load(open(os.path.join(mine['artifact'], pkg.aot.MANIFEST_NAME)))
    assert m == mine['manifest']
    assert m['reduction'] == 'first'
    assert m['input_1_width'] == 6 and m['input_2_width'] == 1
    assert m['output_width'] == 1
    assert set(m['platforms']) == ({'cuda', 'cpu'} if pkg.name == 'torch'
                                   else {'cpu'})
    assert m['model_params']['pre_context'] == 2
    assert os.path.isfile(os.path.join(mine['artifact'], m['program']))
    assert os.path.isfile(os.path.join(mine['artifact'],
                                       'decoder_model.json'))
    assert pkg.aot.is_aot_artifact(mine['artifact'])
    assert not pkg.aot.is_aot_artifact(toy['model_dir'])


def test_manifests_have_the_same_keys_and_metadata(toy):
    port, jax_m = toy['torch']['manifest'], toy['jax']['manifest']
    assert set(port) == set(jax_m)
    assert port['program'] == 'infer_pair.pt2'
    for key in set(port) - {'program', 'platforms'}:
        assert port[key] == jax_m[key], key


def test_infer_pair_matches_live_decoder(toy, pkg):
    rng = np.random.RandomState(7)
    exported = pkg.load_exported(toy[pkg.name]['artifact'])
    for n in (64, 100):   # Two lengths: the frame axis is symbolic.
        x1 = rng.randn(n, 6).astype(np.float32)
        a = np.abs(rng.randn(n, 1)).astype(np.float32)
        b = np.abs(rng.randn(n, 1)).astype(np.float32)
        got_a, got_b = exported.infer_pair(x1, a, b, a, b)
        want_a, want_b = toy[pkg.name]['decoder'].infer_pair(x1, a, b, a, b)
        np.testing.assert_allclose(got_a, want_a, atol=LIVE_TOL)
        np.testing.assert_allclose(got_b, want_b, atol=LIVE_TOL)


def test_infer_one_through_pair_program(toy, pkg):
    rng = np.random.RandomState(8)
    exported = pkg.load_exported(toy[pkg.name]['artifact'])
    x1 = rng.randn(50, 6).astype(np.float32)
    a = np.abs(rng.randn(50, 1)).astype(np.float32)
    got = exported.infer_one({'input_1': x1, 'input_2': a}, a)
    want = toy[pkg.name]['decoder'].infer_one({'input_1': x1, 'input_2': a},
                                              a)
    np.testing.assert_allclose(got, want, atol=LIVE_TOL)


def test_async_returns_the_scores(toy, pkg):
    """infer_pair_async gives infer_pair's scores (in-flight device arrays
    in JAX; on the port's CPU the arrays, on the card a PendingPair,
    tests/test_torch_cuda.py)."""
    rng = np.random.RandomState(9)
    exported = pkg.load_exported(toy[pkg.name]['artifact'])
    x1 = rng.randn(32, 6).astype(np.float32)
    a = np.abs(rng.randn(32, 1)).astype(np.float32)
    sa, sb = exported.infer_pair_async(x1, a, a, a, a)
    ra, rb = exported.infer_pair(x1, a, a, a, a)
    np.testing.assert_allclose(np.asarray(sa), ra, atol=0)
    np.testing.assert_allclose(np.asarray(sb), rb, atol=0)


def test_plain_callable_refused(pkg):
    kwargs = {'device': 'cpu'} if pkg.name == 'torch' else {}
    dec = pkg.live_class(lambda d: np.zeros((3, 1)), reduction='first',
                         **kwargs)
    with pytest.raises(ValueError, match='plain python callable'):
        pkg.export(dec, '/tmp/unused', input_widths=(2, 1), output_width=1)


def test_missing_metadata_needs_explicit_widths(toy, pkg):
    with pytest.raises(ValueError, match='input_widths'):
        pkg.export(toy[pkg.name]['decoder'], '/tmp/unused')


def test_no_statistics_refused(toy, pkg):
    decoder = pkg.load_model(toy['model_dir'], 'first')
    decoder.reset_correlation_statistics()
    with pytest.raises(ValueError, match='count == 0'):
        pkg.export(decoder, '/tmp/unused', input_widths=(6, 1),
                   output_width=1)


def test_version_gate(toy, pkg, tmp_path):
    broken = str(tmp_path / 'broken')
    shutil.copytree(toy[pkg.name]['artifact'], broken)
    mpath = os.path.join(broken, pkg.aot.MANIFEST_NAME)
    m = json.load(open(mpath))
    m['format_version'] = 999
    json.dump(m, open(mpath, 'w'))
    with pytest.raises(ValueError, match='version'):
        pkg.load_exported(broken)


# -- TestServeIntegration of tests/test_aot.py --------------------------------

def test_serve_stream_from_artifact_matches_model_dir(toy, pkg):
    rng = np.random.RandomState(11)
    eeg, a1 = toy['eeg'], toy['a1']
    a2 = np.abs(rng.randn(eeg.shape[0], 1)).astype(np.float32)
    kwargs = dict(chunk_size=37, reduction='first', decision='wta',
                  window_width=100, window_step=100)
    live = pkg.serve_stream(toy['model_dir'], eeg, a1, a2, **kwargs)
    from_artifact = pkg.serve_stream(toy[pkg.name]['artifact'], eeg, a1,
                                     a2, **kwargs)
    assert len(live) == len(from_artifact) > 0
    for d_live, d_art in zip(live, from_artifact):
        assert d_art['attend_speaker1'] == d_live['attend_speaker1']
        assert d_art['score1'] == pytest.approx(d_live['score1'], abs=1e-5)
        assert d_art['score2'] == pytest.approx(d_live['score2'], abs=1e-5)


def test_reduction_mismatch_refused(toy, pkg):
    with pytest.raises(ValueError, match='exported with reduction'):
        pkg.load_serving(toy[pkg.name]['artifact'], 'lda')


def test_no_explicit_reduction_uses_baked_in(toy, pkg):
    dec = pkg.load_serving(toy[pkg.name]['artifact'], None)
    assert dec.reduction == 'first'
    live = pkg.load_serving(toy['model_dir'], None)
    assert isinstance(live, pkg.live_class)
    assert live._reduction == 'lda'


def test_serve_stream_artifact_without_reduction_flag(toy, pkg):
    rng = np.random.RandomState(12)
    eeg, a1 = toy['eeg'], toy['a1']
    a2 = np.abs(rng.randn(eeg.shape[0], 1)).astype(np.float32)
    decisions = pkg.serve_stream(toy[pkg.name]['artifact'], eeg, a1, a2,
                                 chunk_size=37, decision='wta',
                                 window_width=100, window_step=100)
    assert len(decisions) > 0


def test_loader_passthrough_for_model_dirs(toy, pkg):
    dec = pkg.load_serving(toy['model_dir'], 'first')
    assert isinstance(dec, pkg.live_class)


def test_served_artifacts_decide_alike(toy):
    """The port's artifact served by the port and the JAX artifact served
    by the JAX package: the same decisions, scores within SCORE_TOL."""
    rng = np.random.RandomState(13)
    eeg, a1 = toy['eeg'], toy['a1']
    a2 = np.abs(rng.randn(eeg.shape[0], 1)).astype(np.float32)
    got, want = (Package(name).serve_stream(
        toy[name]['artifact'], eeg, a1, a2, chunk_size=37, decision='wta',
        window_width=100, window_step=100) for name in ('torch', 'jax'))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g['attend_speaker1'] == w['attend_speaker1']
        assert g['score1'] == pytest.approx(w['score1'], abs=SCORE_TOL)
        assert g['score2'] == pytest.approx(w['score2'], abs=SCORE_TOL)


# -- TestCli of tests/test_aot.py ---------------------------------------------

def test_export_aot_tool(toy, pkg, tmp_path, capsys):
    out = str(tmp_path / 'cli_artifact')
    pkg.export_aot.app_main(pkg.cli_device + [
        toy['model_dir'], out, '--reduction', 'first', '--platforms=cpu',
        '--input_widths', '6,1', '--output_width=1'])
    assert pkg.aot.is_aot_artifact(out)
    m = json.load(open(os.path.join(out, pkg.aot.MANIFEST_NAME)))
    assert m['platforms'] == ['cpu']
    assert 'reduction=first' in capsys.readouterr().out


def test_cli_usage_error(pkg):
    with pytest.raises(SystemExit, match='usage'):
        pkg.export_aot.app_main(['only_one_arg'])


def test_cli_trailing_flag_without_value(pkg):
    with pytest.raises(SystemExit, match='--reduction needs a value'):
        pkg.export_aot.app_main(['model', 'artifact', '--reduction'])


def test_cli_malformed_input_widths(pkg):
    with pytest.raises(SystemExit, match='exactly two'):
        pkg.export_aot.app_main(['model', 'artifact', '--input_widths',
                                 '6'])
    with pytest.raises(SystemExit, match='two integers'):
        pkg.export_aot.app_main(['model', 'artifact', '--input_widths',
                                 'x,y'])
    with pytest.raises(SystemExit, match='integer'):
        pkg.export_aot.app_main(['model', 'artifact', '--output_width',
                                 'wide'])


def test_cli_malformed_platforms(pkg):
    for bad in ('', ',', ' ', 'tpu,gpu3', 'cpu,cpu'):
        with pytest.raises(SystemExit, match='--platforms'):
            pkg.export_aot.app_main(['model', 'artifact', '--platforms',
                                     bad])


@pytest.mark.parametrize('platforms', ['tpu', 'cuda,rocm', 'tpu,cpu'])
def test_cli_refuses_platforms_the_port_cannot_run(platforms):
    with pytest.raises(SystemExit, match='runs on cuda or cpu'):
        export_aot.app_main(['model', 'artifact', '--platforms', platforms])


def test_platforms_bare_string_is_one_platform(toy, pkg, tmp_path):
    out = str(tmp_path / 'str_platform')
    manifest = pkg.export(toy[pkg.name]['decoder'], out, platforms='cpu',
                          input_widths=(6, 1), output_width=1)
    assert manifest['platforms'] == ['cpu']


def test_export_refuses_platforms_the_port_cannot_run(toy, tmp_path):
    with pytest.raises(ValueError, match='runs on cuda or cpu, not tpu'):
        aot.export_decoder(toy['torch']['decoder'], str(tmp_path / 'x'),
                           platforms=('tpu', 'cpu'), input_widths=(6, 1),
                           output_width=1)


def test_artifact_refuses_a_device_not_exported_for(toy, tmp_path):
    out = str(tmp_path / 'cpu_only')
    aot.export_decoder(toy['torch']['decoder'], out, platforms='cpu',
                       input_widths=(6, 1), output_width=1)
    with pytest.raises(ValueError, match='exported for cpu; it does not '
                                         'serve on cuda'):
        aot.load_exported_decoder(out, 'cuda')


def test_jax_artifact_refused(toy):
    with pytest.raises(ValueError, match='StableHLO, which PyTorch cannot '
                                         'run') as error:
        aot.load_exported_decoder(toy['jax']['artifact'], 'cpu')
    assert 'telluride_decoding_torch.cli.export_aot' in str(error.value)


# -- Every family: the two packages' artifacts, the port's and its decoder -----

def _jax_sgd_dir(path, train, model, decoder_class, regressor):
    model.compile(learning_rate=1e-2)
    model.fit(stacked(train, 1), epochs=3, batch_size=256)
    decoder = decoder_class(model, reduction='lda')
    decoder.train(stacked(train, 2), stacked(train, 1), window_size=100)
    model.add_metadata(dict(FLAGS, dnn_regressor=regressor))
    model.save(path)
    decoder.save_parameters(os.path.join(path, 'decoder_model.json'))


def _family_model_dir(family, path, toy):
    if family == 'linear':
        return toy['model_dir']
    train = recordings(files=3, frames=700)[0]
    if family == 'cca':
        jax_model_dir(path, train)
    elif family == 'dcca':
        _jax_sgd_dir(path, train,
                     JaxDCCA(cca_dims=3, hidden_units=[8],
                             regularization_lambda=1e-2,
                             input1_width=CHANNELS * 5, input2_width=5),
                     jax_infer.CCADecoder, 'dcca')
    else:
        _jax_sgd_dir(path, train,
                     JaxDNN(num_hidden_list=[8], input_width=CHANNELS * 5,
                            output_width=1),
                     jax_infer.LinearRegressionDecoder, 'fullyconnected')
    return path


@pytest.fixture(scope='module')
def families(tmp_path_factory, toy):
    """Per family: the JAX-written model dir, the port's live decoder and
    each package's artifact of it (both exported for the CPU)."""
    out = {}
    for family, widths in WIDTHS.items():
        tmp = tmp_path_factory.mktemp(family)
        model_dir = _family_model_dir(family, str(tmp / 'model'), toy)
        entry = {'model_dir': model_dir}
        for name in PACKAGES:
            package = Package(name)
            decoder = package.load_model(model_dir, REDUCTIONS[family])
            artifact = str(tmp / ('artifact_' + name))
            package.export(decoder, artifact, platforms=('cpu',),
                           input_widths=widths, output_width=1)
            entry[name] = {'decoder': decoder,
                           'exported': package.load_exported(artifact),
                           'artifact': artifact}
        out[family] = entry
    return out


def _inputs(family, frames, seed):
    rng = np.random.RandomState(seed)
    w1, w2 = WIDTHS[family]
    return (rng.randn(frames, w1).astype(np.float32),
            rng.randn(frames, w2).astype(np.float32),
            rng.randn(frames, w2).astype(np.float32),
            np.abs(rng.randn(frames, 1)).astype(np.float32),
            np.abs(rng.randn(frames, 1)).astype(np.float32))


@pytest.mark.parametrize('frames', FRAMES)
@pytest.mark.parametrize('family', list(WIDTHS))
def test_port_artifact_matches_jax_artifact(families, family, frames):
    args = _inputs(family, frames, frames)
    got = families[family]['torch']['exported'].infer_pair(*args)
    want = families[family]['jax']['exported'].infer_pair(*args)
    for g, w in zip(got, want):
        assert g.shape == (frames,)
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize('frames', FRAMES)
@pytest.mark.parametrize('family', list(WIDTHS))
def test_port_artifact_matches_its_live_decoder(families, family, frames):
    args = _inputs(family, frames, 100 + frames)
    got = families[family]['torch']['exported'].infer_pair(*args)
    want = families[family]['torch']['decoder'].infer_pair(*args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=LIVE_TOL)


def _program_graph(artifact):
    return torch.export.load(os.path.join(artifact,
                                          'infer_pair.pt2')).graph


@pytest.mark.parametrize('family', ['cca', 'dcca'])
def test_lda_program_holds_k1_once(families, family):
    """A CCA or deep CCA model with lda: exactly one node of the K1 op,
    and for the CCA no product of its own (a traced plain version would
    rotate input_1 with einsum or mm)."""
    graph = _program_graph(families[family]['torch']['artifact'])
    calls = [n for n in graph.nodes if n.op == 'call_function']
    assert sum(n.target is K1_OP for n in calls) == 1
    if family == 'cca':
        products = {'mm', 'matmul', 'einsum', 'bmm', 'addmm'}
        assert not [n for n in calls
                    if str(n.target).split('.')[:2][-1] in products]


@pytest.mark.parametrize('family', ['linear', 'dnn'])
def test_plain_program_holds_no_k1(families, family):
    graph = _program_graph(families[family]['torch']['artifact'])
    assert not [n for n in graph.nodes if n.target is K1_OP]


def test_k1_op_counts_as_k1_where_it_launches(families):
    """On the CPU the op runs K1's plain version, so the launch counter
    stays (tests/test_torch_cuda.py counts the card's launches)."""
    before = decode_kernel.fused_cca_decode.launches
    families['cca']['torch']['exported'].infer_pair(*_inputs('cca', 32, 1))
    assert decode_kernel.fused_cca_decode.launches == before


def test_fresh_process_loads_through_the_port(families):
    """A process that has not registered the op cannot load the program
    with torch.export.load alone; the port's loader registers it and
    scores as this process does."""
    artifact = families['cca']['torch']['artifact']
    args = _inputs('cca', 17, 5)
    inputs = os.path.join(os.path.dirname(artifact), 'inputs.npz')
    np.savez(inputs, *args)
    code = '\n'.join([
        'import sys, numpy as np, torch',
        'try:',
        '    torch.export.load(sys.argv[1] + "/infer_pair.pt2")',
        '    print("loaded without the op")',
        'except Exception as error:',
        '    print("refused:", type(error).__name__)',
        'from telluride_decoding_torch.decode import aot',
        'with np.load(sys.argv[2]) as data:',
        '    args = [data["arr_%d" % i] for i in range(5)]',
        'scores = aot.load_exported_decoder(sys.argv[1], "cpu")'
        '.infer_pair(*args)',
        'np.save(sys.argv[2] + ".scores.npy", np.stack(scores))'])
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get('PYTHONPATH', ''))
    proc = subprocess.run([sys.executable, '-c', code, artifact, inputs],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith('refused:'), proc.stdout
    want = np.stack(families['cca']['torch']['exported'].infer_pair(*args))
    np.testing.assert_array_equal(np.load(inputs + '.scores.npy'), want)


def test_import_leaves_jax_out_of_the_loader():
    """Loading and serving an artifact imports nothing of JAX."""
    code = ('import sys\n'
            'from telluride_decoding_torch.decode import aot\n'
            'from telluride_decoding_torch.cli import export_aot, serve\n'
            'bad = [m for m in sys.modules if m == "jax" or '
            'm.startswith(("jax.", "telluride_decoding_tpu"))]\n'
            'print(bad)\n')
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get('PYTHONPATH', ''))
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == '[]'


def test_chip_smoke_phase_15_at_a_small_size_on_the_cpu(families, tmp_path):
    """Phase 15's main path and checks (chip_smoke.run_aot, check_aot,
    refuse_jax_artifact) on the CPU, on the CCA, DCCA and DNN directories
    here and a 1500-frame stream of their subject: the CCA artifact's
    decisions and scores are its directory's exactly (pipelined, through
    serve_lines and exported on the CPU too), the others' within
    AOT_TOL."""
    sys.path.insert(0, REPO)
    import chip_smoke
    models = {name: (families[name]['model_dir'], REDUCTIONS[name],
                     ['--input_widths', '%d,%d' % WIDTHS[name],
                      '--output_width', '1'])
              for name in ('cca', 'dcca', 'dnn')}
    stream = recordings(files=1, frames=100, stream_frames=1500)[1]
    work = str(tmp_path / 'aot')
    artifacts, export_s, served, lines = chip_smoke.run_aot(
        'cpu', models, stream, work)
    assert set(export_s) == {'cca', 'dcca', 'dnn',
                             'cca exported on the cpu'}
    worst = chip_smoke.check_aot(served, lines, models, stream, 4, False)
    assert worst['cca'] == 0.0
    assert max(worst.values()) <= chip_smoke.AOT_TOL + chip_smoke.RECORD_UNIT
    for name, (model_dir, reduction, _) in models.items():
        diff = chip_smoke.artifact_score_diff(artifacts[name], model_dir,
                                              reduction, stream, 'cpu')
        assert diff <= (0.0 if name == 'cca' else chip_smoke.AOT_TOL)
    assert all(launches == 0 for *_, launches in served.values())
    assert chip_smoke.served_chunks(1500, 32, 4) == 47
    assert 'StableHLO' in chip_smoke.refuse_jax_artifact(work, 'cpu')
    load_s, first_s, host_ms = chip_smoke.aot_call_times(
        artifacts['dcca'], models['dcca'][0], 'lda', stream, 'cpu', reps=2)
    assert load_s > 0 and first_s > 0
    assert set(host_ms) == {'artifact', 'live'}


def test_a_wrong_width_is_refused_by_the_program(families):
    """The program keeps its shape guards: an input whose width is not
    the manifest's raises."""
    exported = families['cca']['torch']['exported']
    args = list(_inputs('cca', 12, 3))
    args[0] = args[0][:, :-1]
    with pytest.raises(Exception, match='input_1'):
        exported.infer_pair(*args)
