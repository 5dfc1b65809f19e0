"""Small sizes of the cells that came after ``small.py``, registered in
``small.SIZES`` before the tests are collected.

The tests that run every cell on the CPU (``test_every_config_key_is_read``,
``test_sound_run_is_correct``) look each cell's small size up in
``small.SIZES``, which lists the cells that were there when it was
written.  A cell added later gives its size as a file of its own,
``sizes/<cell>.json`` (the configuration's and the traffic's numbers that
change), which is registered here, so those tests cover it and no file
that is there changes.
"""

import json
from pathlib import Path

from gpbench.tests.small import SIZES

for _path in sorted((Path(__file__).parent / "sizes").glob("*.json")):
    SIZES.setdefault(_path.name[:-len(".json")],
                     json.loads(_path.read_text()))
