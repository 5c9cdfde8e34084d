"""Mean host ms of the decision rule's ``attention`` a window (the
benchmark's span around the server's call)."""


def read(readings):
    if readings.get('kind') != 'serve' or not readings['windows']:
        return None
    return readings['attention_s'] / readings['windows'] * 1e3
