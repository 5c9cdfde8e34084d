"""Export a trained model directory as an AOT serving artifact (port of
telluride_decoding_tpu/cli/export_aot.py).

Loads the model directory's decoder on ``--device`` (default cuda; cpu
on request) and writes its two-stream program, with the weights,
correlation statistics and LDA baked in, through ``torch.export``
(decode/aot.py); ``python -m telluride_decoding_torch.cli.serve
--serve_model_dir ARTIFACT_DIR`` serves the artifact directly, with no
model classes and no retracing. For a CCA or deep CCA model with the
LDA reduction the program launches kernel K1 on the card.

Usage:
  python -m telluride_decoding_torch.cli.export_aot MODEL_DIR ARTIFACT_DIR
      [--reduction lda] [--platforms cuda,cpu] [--input_widths W1,W2]
      [--output_width W] [--device cuda]

Widths default to the telluride metadata embedded by cli.decoding; the
explicit flags cover models saved without shape metadata. The port's
program runs on cuda or cpu: tpu and rocm are refused.
"""

from __future__ import annotations

import sys


def export(model_dir: str, artifact_dir: str, *,
           reduction: str = 'lda', platforms=('cuda', 'cpu'),
           input_widths=None, output_width=None, device='cuda') -> None:
    from telluride_decoding_torch.cli.infer import load_model
    from telluride_decoding_torch.decode import aot
    decoder = load_model(model_dir, reduction, device)
    manifest = aot.export_decoder(decoder, artifact_dir,
                                  platforms=platforms,
                                  input_widths=input_widths,
                                  output_width=output_width)
    print('Exported %s -> %s (reduction=%s, platforms=%s, '
          'input widths %d/%d)'
          % (model_dir, artifact_dir, manifest['reduction'],
             ','.join(manifest['platforms']), manifest['input_1_width'],
             manifest['input_2_width']))


_USAGE = ('usage: export_aot MODEL_DIR ARTIFACT_DIR '
          '[--reduction lda] [--platforms cuda,cpu] '
          '[--input_widths W1,W2] [--output_width W] [--device cuda]')


def app_main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    opts = {'reduction': 'lda', 'platforms': 'cuda,cpu',
            'input_widths': None, 'output_width': None, 'device': 'cuda'}
    positional = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        name = arg[2:].split('=', 1)[0] if arg.startswith('--') else None
        if name in opts:
            if '=' in arg:
                opts[name] = arg.split('=', 1)[1]
                i += 1
            else:
                if i + 1 >= len(argv):
                    raise SystemExit('--%s needs a value\n%s'
                                     % (name, _USAGE))
                opts[name] = argv[i + 1]
                i += 2
        else:
            positional.append(arg)
            i += 1
    if len(positional) != 2:
        raise SystemExit(_USAGE)
    input_widths = None
    if opts['input_widths']:
        try:
            input_widths = tuple(
                int(w) for w in opts['input_widths'].split(','))
        except ValueError:
            raise SystemExit('--input_widths must be two integers '
                             'W1,W2 (got %r)\n%s'
                             % (opts['input_widths'], _USAGE))
        if len(input_widths) != 2:
            raise SystemExit('--input_widths must be exactly two '
                             'integers W1,W2 (got %r)\n%s'
                             % (opts['input_widths'], _USAGE))
    try:
        output_width = (int(opts['output_width'])
                        if opts['output_width'] else None)
    except ValueError:
        raise SystemExit('--output_width must be an integer (got %r)\n%s'
                         % (opts['output_width'], _USAGE))
    platforms = tuple(p.strip() for p in opts['platforms'].split(',')
                      if p.strip())
    known = ('tpu', 'cpu', 'cuda', 'rocm')
    bad = [p for p in platforms if p not in known]
    if (not platforms or bad
            or len(set(platforms)) != len(platforms)):
        raise SystemExit('--platforms must be a comma list of DISTINCT '
                         'names drawn from %s (got %r)\n%s'
                         % (','.join(known), opts['platforms'], _USAGE))
    foreign = [p for p in platforms if p not in ('cuda', 'cpu')]
    if foreign:
        raise SystemExit('--platforms: the port\'s program runs on cuda or '
                         'cpu, not %s (got %r)\n%s'
                         % (','.join(foreign), opts['platforms'], _USAGE))
    export(positional[0], positional[1], reduction=opts['reduction'],
           platforms=platforms, input_widths=input_widths,
           output_width=output_width, device=opts['device'])


if __name__ == '__main__':
    app_main()
