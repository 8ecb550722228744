"""One module a job kind (a configuration's ``job``): ``Job`` drives the
program over the cell's stream one pass at a time, hands back the outputs
it kept, and checks them against ``graphbench/reference``."""
