"""The roofline of one H100 (analysis.py) and the static op profile of a
traced step (op_profile.py): what the dry run (launch/dryrun.py) sizes
each cell with, and what chip_smoke.py bounds its kernel rows by."""
