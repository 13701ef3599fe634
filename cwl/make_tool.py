#!/usr/bin/env python3
"""Programmatic CWL CommandLineTool generator for every rkmh-tpu command.

The reference's cwl/rkmh.Rmd is an R-markdown notebook that BUILDS its
CWL tool object programmatically (sevenbridges::Tool + input/output
bindings) and pushes it to the platform (rkmh.Rmd:95-124); the checked-in
cwl/rkmh_classify.json is that generator's output.  This is the same
capability for rkmh-tpu: one generator, one tool JSON per subcommand,
with `classify` reproducing the checked-in cwl/rkmh_tpu_classify.json
byte for byte (tests/test_scripts.py pins it).

    python cwl/make_tool.py classify            # print to stdout
    python cwl/make_tool.py --all -o cwl/       # write every tool JSON
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_F = {"type": "File"}
_FI = lambda p, doc=None: {  # noqa: E731  - table-building shorthand
    **_F, "inputBinding": {"prefix": p}, **({"doc": doc} if doc else {})}
_I = lambda p, default=None: {  # noqa: E731
    "type": "int?", **({"default": default} if default is not None else {}),
    "inputBinding": {"prefix": p}}

# per-command surface: (base command, inputs, stdout template, doc)
TOOLS = {
    "classify": dict(
        base=["rkmh-tpu", "stream"],
        doc=("Classify sequencing reads against a reference panel by "
             "MinHash sketch intersection (GPU-accelerated rkmh). Mirrors the "
             "reference's cwl/rkmh_classify.json tool shape (inputs "
             "-r/-f/-k, stdout capture)."),
        inputs={
            "reference": _FI("-r", "Reference panel FASTA"),
            "reads": _FI("-f", "Reads FASTA/FASTQ (gzip ok)"),
            "kmer": _I("-k", 16),
            "sketch_size": _I("-s", 1000),
            "min_matches": _I("-N"),
            "min_kmer_occurrence": _I("-M"),
        },
        stdout="$(inputs.reads.nameroot).rkmh.tsv",
        output="classifications",
    ),
    "filter": dict(
        base=["rkmh-tpu", "filter"],
        doc="Keep reads matching the reference panel (rkmh filter).",
        inputs={
            "reference": _FI("-r", "Reference panel FASTA"),
            "reads": _FI("-f", "Reads FASTQ (gzip ok)"),
            "kmer": _I("-k", 16),
            "sketch_size": _I("-s", 1000),
            "min_matches": _I("-N"),
            "min_diff": _I("-D"),
        },
        stdout="$(inputs.reads.nameroot).filtered.fq",
        output="passing_reads",
    ),
    "hash": dict(
        base=["rkmh-tpu", "hash"],
        doc="Emit per-read k-mer hashes / sketches (rkmh hash).",
        inputs={
            "reads": _FI("-f", "Reads FASTA/FASTQ"),
            "kmer": _I("-k", 16),
            "sketch_size": _I("-s"),
        },
        stdout="$(inputs.reads.nameroot).hashes.tsv",
        output="hashes",
    ),
    "count": dict(
        base=["rkmh-tpu", "count"],
        doc="Count distinct k-mer hashes per input (rkmh count).",
        inputs={
            "reads": _FI("-f", "Reads FASTA/FASTQ"),
            "kmer": _I("-k", 16),
        },
        stdout="$(inputs.reads.nameroot).counts.tsv",
        output="counts",
    ),
    "search": dict(
        base=["rkmh-tpu", "search"],
        doc="Report which query k-mers appear in a reference k-mer set.",
        inputs={
            "reference": _FI("-r", "Text file of reference k-mers"),
            "reads": _FI("-f", "Reads FASTA/FASTQ"),
            "kmer": _I("-k", 16),
        },
        stdout="$(inputs.reads.nameroot).search.tsv",
        output="matches",
    ),
    "call": dict(
        base=["rkmh-tpu", "call"],
        doc=("Alignment-free variant calling by k-mer mutation "
             "enumeration (rkmh call)."),
        inputs={
            "reference": _FI("-r", "Reference genome FASTA"),
            "reads": _FI("-f", "Reads FASTA/FASTQ"),
            "kmer": _I("-k", 16),
            "window_len": _I("-w", 100),
        },
        stdout="$(inputs.reads.nameroot).vcf",
        output="variants",
    ),
    "hpv16": dict(
        base=["rkmh-tpu", "hpv16"],
        doc=("Tiered HPV type / lineage / sublineage classification "
             "(rkmh hpv16)."),
        inputs={
            "reads": _FI("-f", "Reads FASTA/FASTQ"),
            "refpath": {"type": "Directory",
                        "inputBinding": {"prefix": "-R"},
                        "doc": "Panel dir with all_pave_ref.fa + new_refs.fa"},
            "kmer": _I("-k", 16),
            "sketch_size": _I("-s", 4000),
        },
        stdout="$(inputs.reads.nameroot).hpv16.tsv",
        output="classifications",
    ),
}
TOOLS["stream"] = TOOLS["classify"]


def make_tool(cmd: str) -> dict:
    spec = TOOLS[cmd]
    name = "rkmh_tpu_" + ("classify" if cmd == "stream" else cmd)
    return {
        "cwlVersion": "v1.2",
        "class": "CommandLineTool",
        "id": name,
        "label": "rkmh-tpu " + ("classify" if cmd == "stream" else cmd),
        "doc": spec["doc"],
        "baseCommand": spec["base"],
        "requirements": [
            {"class": "DockerRequirement", "dockerPull": "rkmh-tpu:latest"}
        ],
        "inputs": spec["inputs"],
        "stdout": spec["stdout"],
        "outputs": {spec["output"]: {"type": "stdout"}},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("command", nargs="?", choices=sorted(TOOLS))
    ap.add_argument("--all", action="store_true",
                    help="generate every tool")
    ap.add_argument("-o", "--out-dir", default="",
                    help="write rkmh_tpu_<cmd>.json files here")
    args = ap.parse_args(argv)
    cmds = sorted(c for c in TOOLS if c != "stream") if args.all \
        else [args.command]
    if cmds == [None]:
        ap.error("give a command or --all")
    for cmd in cmds:
        doc = json.dumps(make_tool(cmd), indent=2)
        if args.out_dir:
            # `stream` aliases classify: file name follows the tool id
            name = "classify" if cmd == "stream" else cmd
            path = os.path.join(args.out_dir, f"rkmh_tpu_{name}.json")
            with open(path, "w") as fh:
                fh.write(doc + "\n")
            print(f"wrote {path}", file=sys.stderr)
        else:
            print(doc)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
