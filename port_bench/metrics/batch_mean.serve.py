"""``batch_mean.serve``: the mean batch that the serve engine dispatched in
the window, from its own ``ServeMetrics.record_dispatch`` counter."""


def read(r):
    if r["kind"] != "serve" or not r.get("dispatches"):
        return None
    return sum(r["dispatches"]) / len(r["dispatches"])
