"""The benchmark's traffic: a frozen copy of the port's read simulator
and writers (importing nothing of the port), the genome recipes, and the
generator that turns a configuration and a mix (`mixes/*.json`) into the
files one cell assembles."""
