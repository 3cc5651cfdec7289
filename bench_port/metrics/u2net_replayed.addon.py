"""Share of the add-on's u2net calls that replayed the session's CUDA
graph: 100 x the program's ``matting.u2net_replay`` spans over its
``matting.u2net`` spans, in percent; None without ``matting.u2net``."""


def read(trace, cell):
    calls = len(trace.host_spans.get("matting.u2net", []))
    if not calls:
        return None
    return 100.0 * len(trace.host_spans.get("matting.u2net_replay", [])) / calls
