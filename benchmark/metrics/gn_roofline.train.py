"""K2/K3's share of their roofline (%): the least time of every GroupNorm
forward and backward of the slice's steps (``yardstick.gn_bound_ms`` and
``gnb_bound_ms`` at each call's shape) over the summed time of the ``gn_*``
kernels in the trace."""


def read(rec):
    spent = sum(s for _, s in rec["slice"].kernels(rec["gn_pattern"]))
    if not spent or not rec.get("steps"):
        return None
    least = rec["step"].gn_train_bound_s(rec["itemsize"]) * rec["steps"]
    return 100.0 * least / spent
