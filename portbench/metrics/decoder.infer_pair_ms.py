"""Mean host ms of ``Decoder.infer_pair`` a push (the benchmark's span
around the server's call)."""


def read(readings):
    if readings.get('kind') != 'serve' or not readings['pushes']:
        return None
    return readings['infer_s'] / readings['pushes'] * 1e3
