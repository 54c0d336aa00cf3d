"""One driver a traffic kind (a traffic file's ``kind``): its generator and
its driving of the program's entry point."""
