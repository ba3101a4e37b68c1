"""One driver per kind of traffic, named by a traffic file's ``kind``."""
