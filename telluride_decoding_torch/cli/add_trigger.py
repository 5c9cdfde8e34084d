"""Trigger authoring tool: adds event pulses to a wav as its second
channel (port of cli/add_trigger.py).

  python -m telluride_decoding_torch.cli.add_trigger \\
      --input_filename in.wav --output_filename out.wav \\
      [--number_of_events -5] [--pulse_length 0.1] [--pulse_freq 0]

The flags keep the JAX names and defaults. A negative
``--number_of_events -X`` asks for one event per X seconds. Event times
come from the exact spacing construction, one draw from ``rng`` (a
fresh unseeded ``np.random.RandomState`` unless the caller passes one).
Host code only: numpy and scipy's wav I/O.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

import numpy as np
import scipy.io.wavfile

from telluride_decoding_torch.cli import decoding


def random_times(duration: float, number: int,
                 minimum_interval: float = 0.5,
                 include_zero: bool = True,
                 rng: Optional[np.random.RandomState] = None):
    """Sorted random event times with a guaranteed minimum spacing.

    Subtracting i * minimum_interval from the i-th sorted event maps the
    constrained space onto plain sorted uniforms, so one draw always
    succeeds when the constraint is feasible.
    """
    if (number - 1) * minimum_interval > duration:
        raise ValueError('Not enough time for %d events with %gs between '
                         'them in %gs.' % (number, minimum_interval,
                                           duration))
    number = int(number)
    rng = rng or np.random.RandomState()
    if number <= 0:
        return np.zeros((0,), np.float64)
    free = duration - (number - 1) * minimum_interval
    if include_zero:
        u = (np.sort(rng.uniform(0, free, size=number - 1))
             if number > 1 else np.zeros((0,)))
        return np.concatenate(
            [[0.0], u + minimum_interval * np.arange(1, number)])
    u = np.sort(rng.uniform(0, free, size=number))
    return u + minimum_interval * np.arange(number)


def add_events_to_audio(audio_signal: np.ndarray, event_times,
                        fs: float = 16000, pulse_length: float = 0.1,
                        pulse_freq: float = 0) -> np.ndarray:
    """Returns stereo int16 audio: the original in channel 0, pulses (or
    tone bursts at ``pulse_freq``) in channel 1."""
    if not isinstance(audio_signal, np.ndarray):
        raise TypeError('audio signal must be an np.ndarray')
    audio_signal = audio_signal.astype(np.int16).squeeze()
    if audio_signal.ndim > 1:
        audio_signal = np.mean(
            audio_signal, axis=tuple(range(1, audio_signal.ndim)))
    if audio_signal.ndim != 1:
        raise TypeError('audio signal (after squeezing) must be '
                        '1-dimensional.')
    if fs < 8000.0:
        raise ValueError('Sampling rate is generally > 8000Hz.')
    if not isinstance(event_times, (list, np.ndarray)) or \
            len(event_times) < 3:
        raise ValueError('event_times must be a list of at least 3 '
                         'elements.')
    audio_length = audio_signal.shape[0]
    new_channel = np.zeros((audio_length, 1), dtype=np.float64)
    for t in np.asarray(event_times) * fs:
        t = int(t)
        new_channel[t:t + int(fs * pulse_length)] = 32767
    if pulse_freq > 0:
        phase = np.arange(audio_length).reshape(-1, 1) / float(fs)
        new_channel = new_channel * np.sin(2 * np.pi * pulse_freq * phase)
    return np.concatenate(
        (audio_signal.reshape(-1, 1), new_channel.reshape(-1, 1)),
        axis=1).astype(np.int16)


def read_audio_wave_file(audio_filename: str):
    if not isinstance(audio_filename, str):
        raise TypeError('audio_filename must be a string.')
    fs, audio_signal = scipy.io.wavfile.read(audio_filename)
    return fs, audio_signal


def write_audio_wave_file(audio_filename: str, audio_signal: np.ndarray,
                          fs: float):
    if not isinstance(audio_filename, str):
        raise TypeError('audio_filename must be a string.')
    if not isinstance(audio_signal, np.ndarray):
        raise TypeError('audio_signal must be an np.ndarray')
    scipy.io.wavfile.write(audio_filename, int(fs), audio_signal)


# (name, type, default, choices, help): the JAX tool's own flags
# (telluride_decoding_tpu/cli/add_trigger.py:26-36).
_FLAGS = [
    ('input_filename', str, None, None, 'Input audio filename'),
    ('output_filename', str, None, None, 'Output audio filename'),
    ('number_of_events', int, -1, None,
     'Number of events to add (-X for 1 per X seconds.)'),
    ('verbose', bool, False, None, 'Show log messages.'),
    ('pulse_length', float, 0.1, None, 'Length of the pulse (seconds)'),
    ('pulse_freq', float, 0, None, 'Frequency of the pulse (Hz)'),
]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog='python -m telluride_decoding_torch.cli.add_trigger',
        description=__doc__.split('\n\n')[0], allow_abbrev=False)
    decoding.add_flags(parser, _FLAGS)
    return parser


def main(argv: Optional[List[str]] = None,
         rng: Optional[np.random.RandomState] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for name in ('input_filename', 'output_filename'):
        if getattr(args, name) is None:
            parser.error('--%s is required' % name)
    if args.verbose:
        logging.basicConfig(level=logging.INFO)
    if args.pulse_length <= 0.0:
        raise ValueError('Pulse length (%g) must be greater than 0.' %
                         args.pulse_length)
    audio_fs, audio_signal = read_audio_wave_file(args.input_filename)
    audio_seconds = audio_signal.shape[0] / float(audio_fs)
    if args.number_of_events < 0:
        number = int(audio_seconds) // (-args.number_of_events)
    elif args.number_of_events == 0:
        raise ValueError('Can not add 0 events.')
    else:
        number = args.number_of_events
    event_times = random_times(audio_seconds - 2 * args.pulse_length,
                               number=number, minimum_interval=0.5,
                               include_zero=True, rng=rng)
    stereo = add_events_to_audio(audio_signal, event_times, audio_fs,
                                 pulse_length=args.pulse_length,
                                 pulse_freq=args.pulse_freq)
    write_audio_wave_file(args.output_filename, stereo, audio_fs)
    print('Wrote %d events to %s.' % (len(event_times),
                                      args.output_filename))
    return 0


if __name__ == '__main__':
    sys.exit(main())
