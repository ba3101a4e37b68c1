"""Device kernels launched in the traced slice per optimizer step (copies
and fills not counted)."""


def read(rec):
    if not rec.get("steps"):
        return None
    return len(rec["slice"].kernels()) / rec["steps"]
