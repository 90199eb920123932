"""CPU tests of the benchmark's harness, generators, counting and plain
references (small shapes; the card is never looked for)."""
