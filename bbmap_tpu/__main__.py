"""Tool dispatcher: ``python -m bbmap_tpu <tool> key=value ...``

The analog of the reference's one-shell-script-per-tool layer (reference:
sh/ — bbmap.sh, bbduk.sh, ...). Each tool is a module with main(argv).
"""

from __future__ import annotations

import importlib
import os
import sys

if os.environ.get("BBMAP_FORCE_CPU"):
    # test/CI hook: pin JAX to the CPU backend before any tool uses a
    # device (set through jax.config after import, like
    # tests/conftest.py)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices",
                      int(os.environ.get("BBMAP_CPU_DEVICES", "1")))

TOOLS = {
    "bbmap": "bbmap_tpu.tools.bbmap",
    "bbduk": "bbmap_tpu.tools.bbduk",
    "bbmerge": "bbmap_tpu.tools.bbmerge",
    "reformat": "bbmap_tpu.tools.reformat",
    "randomreads": "bbmap_tpu.tools.randomreads",
    "gradesam": "bbmap_tpu.tools.gradesam",
    "samtoroc": "bbmap_tpu.tools.samtoroc",
    "comparesam": "bbmap_tpu.tools.comparesam",
    "stats": "bbmap_tpu.tools.stats",
    "kmercountexact": "bbmap_tpu.tools.kmercountexact",
    "bbnorm": "bbmap_tpu.tools.bbnorm",
    "khist": "bbmap_tpu.tools.kmercountexact",
    "dedupe": "bbmap_tpu.tools.dedupe",
    "clumpify": "bbmap_tpu.tools.clumpify",
    "bbmask": "bbmap_tpu.tools.bbmask",
    "pileup": "bbmap_tpu.tools.pileup",
    "tadpole": "bbmap_tpu.tools.tadpole",
    "seal": "bbmap_tpu.tools.seal",
    "mappacbio": "bbmap_tpu.tools.mappacbio",
    "bbsplit": "bbmap_tpu.tools.bbsplit",
    "loglog": "bbmap_tpu.tools.loglog",
    "sketch": "bbmap_tpu.tools.sketch",
    "comparesketch": "bbmap_tpu.tools.sketch",
    "bbcountunique": "bbmap_tpu.tools.bbcountunique",
    "calctruequality": "bbmap_tpu.tools.calctruequality",
    "rqcfilter": "bbmap_tpu.tools.rqcfilter",
    "bbqc": "bbmap_tpu.tools.rqcfilter",
    "bbduk2": "bbmap_tpu.tools.bbduk2",
    "removesmartbell": "bbmap_tpu.tools.removesmartbell",
    "liftover": "bbmap_tpu.tools.liftover",
    "translator": "bbmap_tpu.tools.liftover",
}

# multi-command modules: tool name -> (module, function)
SUBTOOLS = {
    "dedupe2": ("bbmap_tpu.tools.dedupe", "dedupe2_main"),
    "countbarcodes": ("bbmap_tpu.tools.barcodes", "countbarcodes"),
    "mergebarcodes": ("bbmap_tpu.tools.barcodes", "mergebarcodes"),
    "correlatebarcodes": ("bbmap_tpu.tools.barcodes",
                          "correlatebarcodes"),
    "filterbarcodes": ("bbmap_tpu.tools.barcodes", "filterbarcodes"),
    "removebadbarcodes": ("bbmap_tpu.tools.barcodes",
                          "removebadbarcodes"),
    "mutategenome": ("bbmap_tpu.tools.synth", "mutategenome"),
    "shred": ("bbmap_tpu.tools.synth", "shred"),
    "makechimeras": ("bbmap_tpu.tools.synth", "makechimeras"),
    "addadapters": ("bbmap_tpu.tools.synth", "addadapters"),
    "fakereads": ("bbmap_tpu.tools.synth", "fakereads"),
    "synthmda": ("bbmap_tpu.tools.synth", "synthmda"),
    "fungalrelease": ("bbmap_tpu.tools.synth", "fungalrelease"),
    "splitpairs": ("bbmap_tpu.tools.pairtools", "splitpairs"),
    "bbsplitpairs": ("bbmap_tpu.tools.pairtools", "splitpairs"),
    "repair": ("bbmap_tpu.tools.pairtools", "splitpairs"),
    "filterbyname": ("bbmap_tpu.tools.pairtools", "filterbyname"),
    "demuxbyname": ("bbmap_tpu.tools.pairtools", "demuxbyname"),
    "sortsam": ("bbmap_tpu.tools.sorttools", "sortsam"),
    "callvariants": ("bbmap_tpu.tools.callvariants", "main"),
    "applyvariants": ("bbmap_tpu.tools.callvariants", "applyvariants"),
    "printtaxonomy": ("bbmap_tpu.tools.taxonomy", "printtaxonomy"),
    "findancestor": ("bbmap_tpu.tools.taxonomy", "findancestor"),
    "filterbytaxa": ("bbmap_tpu.tools.taxonomy", "filterbytaxa"),
    "filterbycoverage": ("bbmap_tpu.tools.covtools", "filterbycoverage"),
    "decontaminate": ("bbmap_tpu.tools.covtools", "decontaminate"),
    "kmercoverage": ("bbmap_tpu.tools.covtools", "kmercoverage"),
    "crosscontaminate": ("bbmap_tpu.tools.covtools", "crosscontaminate"),
    "shuffle": ("bbmap_tpu.tools.misc", "shuffle"),
    "partition": ("bbmap_tpu.tools.misc", "partition"),
    "translate6frames": ("bbmap_tpu.tools.misc", "translate6frames"),
    "kcompress": ("bbmap_tpu.tools.misc", "kcompress"),
    "bbwrap": ("bbmap_tpu.tools.misc", "bbwrap"),
    "sortbyname": ("bbmap_tpu.tools.sorttools", "sortbyname"),
    "grademerge": ("bbmap_tpu.tools.sorttools", "grademerge"),
    # pacbio aux pipeline (reference: pacbio/ package)
    "stacksites": ("bbmap_tpu.tools.pacbio", "stacksites_main"),
    "calccoveragefromsites": ("bbmap_tpu.tools.pacbio",
                              "calccoverage_main"),
    "processstackedsites": ("bbmap_tpu.tools.pacbio",
                            "processstacked_main"),
    "mergefastacontigs": ("bbmap_tpu.tools.pacbio",
                          "mergefastacontigs_main"),
    "partitionreads": ("bbmap_tpu.tools.pacbio", "partitionreads_main"),
    "partitionfastafile": ("bbmap_tpu.tools.pacbio",
                           "partitionfastafile_main"),
    "removenfromchromosome": ("bbmap_tpu.tools.pacbio",
                              "removenfromchromosome_main"),
    "sortsites": ("bbmap_tpu.tools.pacbio", "sortsites_main"),
    "splitoffperfectcontigs": ("bbmap_tpu.tools.pacbio",
                               "splitoffperfectcontigs_main"),
    "bbmapskimmer": ("bbmap_tpu.tools.bbmap", "skimmer_main"),
    "bbmapacc": ("bbmap_tpu.tools.bbmap", "acc_main"),
    "bbmap5": ("bbmap_tpu.tools.bbmap", "bbmap5_main"),
    "mappacbioskimmer": ("bbmap_tpu.tools.mappacbio",
                         "skimmer_main"),
    "ecc": ("bbmap_tpu.tools.bbnorm", "ecc_main"),
    "tadpolewrapper": ("bbmap_tpu.tools.tadpole", "wrapper_main"),
    "splitnexteralmp": ("bbmap_tpu.tools.pairtools",
                        "splitnexteralmp"),
    "reclusterbykmer": ("bbmap_tpu.tools.recluster", "main"),
    # driver/ text utilities
    "concatenatetextfiles": ("bbmap_tpu.tools.textutils",
                             "concatenatetextfiles"),
    "filterlines": ("bbmap_tpu.tools.textutils", "filterlines"),
    "countsharedlines": ("bbmap_tpu.tools.textutils",
                         "countsharedlines"),
    "replaceheaders": ("bbmap_tpu.tools.textutils", "replaceheaders"),
    "statswrapper": ("bbmap_tpu.tools.textutils", "statswrapper"),
    "filterbysequence": ("bbmap_tpu.tools.misc", "filterbysequence"),
    "bbgrep": ("bbmap_tpu.tools.textutils", "grep"),
    "linecount": ("bbmap_tpu.tools.textutils", "linecount"),
    "renamebyheader": ("bbmap_tpu.tools.textutils", "renamebyheader"),
    # jgi/driver long tail (tools/smalltools.py)
    "countgc": ("bbmap_tpu.tools.smalltools", "countgc"),
    "readlength": ("bbmap_tpu.tools.smalltools", "readlength"),
    "fuse": ("bbmap_tpu.tools.smalltools", "fuse"),
    "getreads": ("bbmap_tpu.tools.smalltools", "getreads"),
    "splitsam": ("bbmap_tpu.tools.smalltools", "splitsam"),
    "rename": ("bbmap_tpu.tools.smalltools", "rename"),
    "testformat": ("bbmap_tpu.tools.smalltools", "testformat"),
    "textfile": ("bbmap_tpu.tools.smalltools", "textfile"),
    "printtime": ("bbmap_tpu.tools.smalltools", "printtime"),
    "phylip2fasta": ("bbmap_tpu.tools.smalltools", "phylip2fasta"),
    "matrixtocolumns": ("bbmap_tpu.tools.smalltools", "matrixtocolumns"),
    "mergeotus": ("bbmap_tpu.tools.smalltools", "mergeotus"),
    "summarizescafstats": ("bbmap_tpu.tools.smalltools",
                           "summarizescafstats"),
    "summarizeseal": ("bbmap_tpu.tools.smalltools", "summarizeseal"),
    "muxbyname": ("bbmap_tpu.tools.smalltools", "muxbyname"),
    "filtersubs": ("bbmap_tpu.tools.smalltools", "filtersubs"),
    "reducesilva": ("bbmap_tpu.tools.smalltools", "reducesilva"),
    "estherfilter": ("bbmap_tpu.tools.smalltools", "estherfilter"),
    "bbest": ("bbmap_tpu.tools.smalltools", "bbest"),
    "summarizecrossblock": ("bbmap_tpu.tools.smalltools",
                            "summarizecrossblock"),
    "summarizemerge": ("bbmap_tpu.tools.smalltools", "summarizemerge"),
    "processfrag": ("bbmap_tpu.tools.smalltools", "processfrag"),
    "filterassemblysummary": ("bbmap_tpu.tools.smalltools",
                              "filterassemblysummary"),
    "dedupebymapping": ("bbmap_tpu.tools.smalltools",
                        "dedupebymapping"),
    "postfilter": ("bbmap_tpu.tools.covtools", "postfilter"),
    "callpeaks": ("bbmap_tpu.tools.kmercountexact", "callpeaks_main"),
    # taxonomy suite (tools/taxonomy.py)
    "taxtree": ("bbmap_tpu.tools.taxonomy", "taxtree_build"),
    "gitable": ("bbmap_tpu.tools.taxonomy", "gitable"),
    "gi2taxid": ("bbmap_tpu.tools.taxonomy", "gi2taxid"),
    "gi2ancestors": ("bbmap_tpu.tools.taxonomy", "gi2ancestors"),
    "sortbytaxa": ("bbmap_tpu.tools.taxonomy", "sortbytaxa"),
    "splitbytaxa": ("bbmap_tpu.tools.taxonomy", "splitbytaxa"),
    "taxonomy": ("bbmap_tpu.tools.taxonomy", "printtaxonomy"),
    # alignment small tools (tools/idtools.py)
    "idmatrix": ("bbmap_tpu.tools.idtools", "idmatrix"),
    "idtree": ("bbmap_tpu.tools.idtools", "idtree"),
    "msa": ("bbmap_tpu.tools.idtools", "msa"),
    "cutprimers": ("bbmap_tpu.tools.idtools", "cutprimers"),
    "commonkmers": ("bbmap_tpu.tools.idtools", "commonkmers"),
    # aliases for reference sh-script names served by existing tools
    "bbfakereads": ("bbmap_tpu.tools.synth", "fakereads"),
    "bbmerge-auto": ("bbmap_tpu.tools.bbmerge", "main"),
    "crossblock": ("bbmap_tpu.tools.covtools", "decontaminate"),
    "mutate": ("bbmap_tpu.tools.synth", "mutategenome"),
    "splitnextera": ("bbmap_tpu.tools.pairtools", "splitnexteralmp"),
    "tadwrapper": ("bbmap_tpu.tools.tadpole", "wrapper_main"),
}


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help", "help"):
        print("usage: python -m bbmap_tpu <tool> key=value ...")
        print("tools: " + ", ".join(sorted(TOOLS)))
        return 0
    tool = sys.argv[1].lower()
    if tool in TOOLS:
        mod = importlib.import_module(TOOLS[tool])
        return mod.main(sys.argv[2:])
    if tool in SUBTOOLS:
        modname, fn = SUBTOOLS[tool]
        mod = importlib.import_module(modname)
        return getattr(mod, fn)(sys.argv[2:])
    print(f"unknown tool {tool!r}; available: "
          + ", ".join(sorted(list(TOOLS) + list(SUBTOOLS))))
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
