"""Set-up: process start to the first timed unit (inputs made on the device,
the program built, one unit run to capture every program; the first run in a
checkout also builds the kernels)."""


def read(record):
    return record["setup_s"]
