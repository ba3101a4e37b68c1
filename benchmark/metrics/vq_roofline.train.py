"""K1's share of its roofline (%): the least time of the slice's VQ
searches (``yardstick.vq_bound_ms``; statistics mode for an EMA codebook,
ids mode otherwise) over the summed time of the ``vq_*`` kernels in the
trace."""


def read(rec):
    spent = sum(s for _, s in rec["slice"].kernels(rec["vq_pattern"]))
    if not spent or not rec.get("steps"):
        return None
    return 100.0 * rec["step"].vq_bound_s() * rec["steps"] / spent
