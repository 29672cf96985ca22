#!/bin/bash
# Run the toy workflow on the port's commands (panvc3_torch_*) in a work
# directory of its own: the data is copied there, and nothing is written
# beside this script.  Requires snakemake, bowtie2, samtools, bzip2 and gzip
# on PATH, and the package installed (pip install --no-deps <checkout>).
#
#   run-snakemake.sh DATA_DIR WORK_DIR [snakemake options]
#
# DATA_DIR is the bundled data, workflows/test-workflow/data of a checkout.
# Options are passed to snakemake, e.g. --config device=cpu on a machine
# without a card.

set -euxo pipefail

usage="usage: $0 DATA_DIR WORK_DIR [snakemake options]"
here="$(cd "$(dirname "$0")" && pwd)"
data="${1:?$usage}"
work="${2:?$usage}"
shift 2

mkdir -p "$work"
cp -R "$data"/. "$work"/
cd "$work"
snakemake --printshellcmds --snakefile "$here/Snakefile" \
	--configfile "$here/example-config.yaml" --cores "${CORES:-16}" "$@"
