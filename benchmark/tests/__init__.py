"""CPU tests of the benchmark (cards: ``-m cuda``)."""
