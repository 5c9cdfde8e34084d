"""Mean host ms a push outside the decoder's and the decision rule's
spans: the serving loop's own work (context buffers, queues, window
store)."""


def read(readings):
    if readings.get('kind') != 'serve' or not readings['pushes']:
        return None
    own = readings['push_s'] - readings['infer_s'] - readings['attention_s']
    return own / readings['pushes'] * 1e3
