"""Drivers of the traffic kinds: a mix's ``entry`` names one."""
