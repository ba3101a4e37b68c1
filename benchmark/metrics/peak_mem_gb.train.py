"""The most device memory the allocator held during the window, in GB
(``torch.cuda.max_memory_allocated`` reset when the window opens)."""


def read(rec):
    if not rec.get("peak_window_bytes"):
        return None
    return rec["peak_window_bytes"] / 1e9
