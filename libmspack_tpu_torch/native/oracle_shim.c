/* Flat C entry points over the reference libmspack: the port's copy of
 * tests/oracle_shim.c, compiled with the reference's sources where they
 * are there (native/reference.py), for the port bench's baseline. */
#include <stdio.h>
#include <string.h>
#include <stdlib.h>
#include <mspack.h>

int oracle_szdd(const char *in, const char *out) {
    struct msszdd_decompressor *d = mspack_create_szdd_decompressor(NULL);
    int err;
    if (!d) return -1;
    err = d->decompress(d, in, out);
    mspack_destroy_szdd_decompressor(d);
    return err;
}

int oracle_kwaj(const char *in, const char *out) {
    struct mskwaj_decompressor *d = mspack_create_kwaj_decompressor(NULL);
    int err;
    if (!d) return -1;
    err = d->decompress(d, in, out);
    mspack_destroy_kwaj_decompressor(d);
    return err;
}

/* returns KWAJ parsed filename (or "<none>") and error code */
int oracle_kwaj_header(const char *in, char *namebuf, int buflen, unsigned int *length) {
    struct mskwaj_decompressor *d = mspack_create_kwaj_decompressor(NULL);
    struct mskwajd_header *h;
    int err = 0;
    if (!d) return -1;
    h = d->open(d, in);
    if (!h) { err = d->last_error(d); }
    else {
        snprintf(namebuf, buflen, "%s", h->filename ? h->filename : "<none>");
        *length = (unsigned int) h->length;
        d->close(d, h);
    }
    mspack_destroy_kwaj_decompressor(d);
    return err;
}

/* list cab contents to a text file: one "length<TAB>folderidx<TAB>offset<TAB>comptype<TAB>name" per line */
int oracle_cab_list(const char *cabfile, const char *listfile) {
    struct mscab_decompressor *d = mspack_create_cab_decompressor(NULL);
    struct mscabd_cabinet *cab;
    struct mscabd_file *f;
    FILE *fh;
    int err = 0;
    if (!d) return -1;
    cab = d->open(d, cabfile);
    if (!cab) { err = d->last_error(d); mspack_destroy_cab_decompressor(d); return err; }
    fh = fopen(listfile, "w");
    for (f = cab->files; f; f = f->next) {
        fprintf(fh, "%lld\t%d\t%lld\t%d\t%s\n", (long long) f->length,
                0, (long long) f->offset, f->folder ? f->folder->comp_type : -1, f->filename);
    }
    fclose(fh);
    d->close(d, cab);
    mspack_destroy_cab_decompressor(d);
    return err;
}

/* extract a single named member of a cab (after prepending/appending spans) */
int oracle_cab_extract(const char *cabfile, const char *member, const char *out,
                       int salvage, int fix_mszip) {
    struct mscab_decompressor *d = mspack_create_cab_decompressor(NULL);
    struct mscabd_cabinet *cab;
    struct mscabd_file *f;
    int err = -2;
    if (!d) return -1;
    if (salvage)   d->set_param(d, MSCABD_PARAM_SALVAGE, 1);
    if (fix_mszip) d->set_param(d, MSCABD_PARAM_FIXMSZIP, 1);
    cab = d->open(d, cabfile);
    if (!cab) { err = d->last_error(d); mspack_destroy_cab_decompressor(d); return err; }
    for (f = cab->files; f; f = f->next) {
        if (strcmp(f->filename, member) == 0) {
            err = d->extract(d, f, out);
            break;
        }
    }
    d->close(d, cab);
    mspack_destroy_cab_decompressor(d);
    return err;
}

/* extract all members in listed order to outdir/m<N>; write names list */
int oracle_cab_extract_all(const char *cabfile, const char *outdir,
                           int salvage, int fix_mszip) {
    struct mscab_decompressor *d = mspack_create_cab_decompressor(NULL);
    struct mscabd_cabinet *cab;
    struct mscabd_file *f;
    char path[4096];
    int err = 0, idx = 0;
    if (!d) return -1;
    if (salvage)   d->set_param(d, MSCABD_PARAM_SALVAGE, 1);
    if (fix_mszip) d->set_param(d, MSCABD_PARAM_FIXMSZIP, 1);
    cab = d->open(d, cabfile);
    if (!cab) { err = d->last_error(d); mspack_destroy_cab_decompressor(d); return err; }
    for (f = cab->files; f; f = f->next, idx++) {
        int e;
        snprintf(path, sizeof path, "%s/m%d", outdir, idx);
        e = d->extract(d, f, path);
        if (e && !err) err = e;
    }
    d->close(d, cab);
    mspack_destroy_cab_decompressor(d);
    return err;
}

int oracle_chm_extract_all(const char *chmfile, const char *outdir) {
    struct mschm_decompressor *d = mspack_create_chm_decompressor(NULL);
    struct mschmd_header *chm;
    struct mschmd_file *f;
    char path[4096];
    int err = 0, idx = 0;
    if (!d) return -1;
    chm = d->open(d, chmfile);
    if (!chm) { err = d->last_error(d); mspack_destroy_chm_decompressor(d); return err; }
    for (f = chm->files; f; f = f->next, idx++) {
        int e;
        snprintf(path, sizeof path, "%s/m%d", outdir, idx);
        e = d->extract(d, f, path);
        if (e && !err) err = e;
    }
    d->close(d, chm);
    mspack_destroy_chm_decompressor(d);
    return err;
}

int oracle_chm_list(const char *chmfile, const char *listfile) {
    struct mschm_decompressor *d = mspack_create_chm_decompressor(NULL);
    struct mschmd_header *chm;
    struct mschmd_file *f;
    FILE *fh;
    int err = 0;
    if (!d) return -1;
    chm = d->open(d, chmfile);
    if (!chm) { err = d->last_error(d); mspack_destroy_chm_decompressor(d); return err; }
    fh = fopen(listfile, "w");
    for (f = chm->files; f; f = f->next) {
        fprintf(fh, "%lld\t%lld\t%d\t%s\n", (long long)f->length, (long long)f->offset,
                f->section ? (int)f->section->id : -1, f->filename);
    }
    fclose(fh);
    d->close(d, chm);
    mspack_destroy_chm_decompressor(d);
    return err;
}

int oracle_oab(const char *in, const char *out) {
    struct msoab_decompressor *d = mspack_create_oab_decompressor(NULL);
    int err;
    if (!d) return -1;
    err = d->decompress(d, in, out);
    mspack_destroy_oab_decompressor(d);
    return err;
}

int oracle_oab_incremental(const char *patch, const char *base, const char *out) {
    struct msoab_decompressor *d = mspack_create_oab_decompressor(NULL);
    int err;
    if (!d) return -1;
    err = d->decompress_incremental(d, patch, base, out);
    mspack_destroy_oab_decompressor(d);
    return err;
}
