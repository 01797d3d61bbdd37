"""Golden-output configurations: frozen artifacts pinning the exact
output bytes of every major mode (per-mode parity declaration with
frozen goldens). Regenerate with
`python tests/gen_goldens.py` ONLY when a documented semantic deviation
changes; any other diff is a regression.

All configs run from a directory containing the deterministic fixtures
(make_fixtures.make(..., n_genomes=6, length=4000, seed=42)) so paths in
text outputs are stable relative names.
"""

N_GENOMES = 6
LENGTH = 4000

FA = [f"g{i}.fa" for i in range(N_GENOMES)]

# name -> (cli args producing <name> as the output file, [extra artifacts])
CONFIGS = {
    "oph_phylip.txt": (["sketch", "-k", "17", "-S", "128",
                        "--cmpout", "oph_phylip.txt"] + FA, []),
    "oph_sim.bin": (["sketch", "-k", "17", "-S", "128", "--binary-output",
                     "--cmpout", "oph_sim.bin"] + FA, []),
    "full_sim.bin": (["sketch", "-k", "17", "-S", "128", "--full",
                      "--binary-output", "--cmpout", "full_sim.bin"] + FA,
                     []),
    "fastcmp_nibble.bin": (["sketch", "-k", "17", "-S", "128",
                            "--fastcmp", "0.5", "--binary-output",
                            "--cmpout", "fastcmp_nibble.bin"] + FA, []),
    "fastcmp_bbit.bin": (["sketch", "-k", "17", "-S", "128",
                          "--fastcmp", "1", "--bbit-sigs",
                          "--binary-output",
                          "--cmpout", "fastcmp_bbit.bin"] + FA, []),
    "exact_set.bin": (["sketch", "-k", "17", "--set", "--binary-output",
                       "--cmpout", "exact_set.bin"] + FA, []),
    "multiset.bin": (["sketch", "-k", "17", "-S", "128", "--multiset",
                      "--binary-output", "--cmpout", "multiset.bin"] + FA,
                     []),
    "prob.bin": (["sketch", "-k", "17", "-S", "128", "--prob",
                  "--binary-output", "--cmpout", "prob.bin"] + FA, []),
    "knn.bin": (["sketch", "-k", "17", "-S", "128", "--topk", "2",
                 "--binary-output", "--cmpout", "knn.bin"] + FA, []),
    "dedup.bin": (["sketch", "-k", "17", "-S", "128", "--greedy", "0.8",
                   "--binary-output", "--cmpout", "dedup.bin"] + FA, []),
    "sigs.bin": (["sketch", "-k", "17", "-S", "128", "-o", "sigs.bin",
                  "--cmpout", "/dev/null"] + FA, ["sigs.bin.names.txt"]),
    "mash_dist.txt": (["sketch", "-k", "17", "-S", "128", "--mash-dist",
                       "--cmpout", "mash_dist.txt"] + FA, []),
}


def run_all(workdir: str):
    """Generate fixtures + all artifacts inside workdir; returns the
    list of produced artifact paths (relative)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from make_fixtures import make
    from dashing2_tpu.cli import main
    make(workdir, n_genomes=N_GENOMES, length=LENGTH, seed=42)
    cwd = os.getcwd()
    produced = []
    os.chdir(workdir)
    try:
        for name, (args, extras) in CONFIGS.items():
            rc = main(list(args))
            assert rc == 0, (name, rc)
            produced.append(name)
            produced.extend(extras)
    finally:
        os.chdir(cwd)
    return produced
