"""Share of the add-on's requests whose frontend ran on the card: 100 x
the program's ``frontend.on_card`` spans over its ``frontend.preprocess``
spans, in percent; None without ``frontend.preprocess``."""


def read(trace, cell):
    requests = len(trace.host_spans.get("frontend.preprocess", []))
    if not requests:
        return None
    return 100.0 * len(trace.host_spans.get("frontend.on_card", [])) / requests
